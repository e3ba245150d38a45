"""The port's weighted route against the JAX package's, on the CPU: the
cost column of the graph (the .bin weight section, ``from_edges``,
``deduped_weighted``), the relaxation pass (K12's plain version against
JAX's ``_relax_scatter_min``), every flavor's drive loop (distances, F,
query stats and the five counters), the edge cases and the refusals.
Inputs are made from seeds with NumPy and handed to both packages; every
comparison is exact (all values are integers)."""

import numpy as np
import pytest
import torch

from oracle import oracle_dijkstra
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    weighted as jw,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    generators as jgen,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.bell import (
    BellGraph as JBellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.csr import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    certify as jcertify,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    supervisor as jsup,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
    io as jio,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.weighted import (
    deltastep as jds,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import (
    weighted as tw,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    csr as csr_mod,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    certify,
    cuda_weighted,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    native_loader,
    supervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io as tio,
)


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    yield
    faults.activate(None)
    jfaults.activate(None)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _same_dedup(got, want):
    """The port's weighted dedup against JAX's: the same values, the
    indices int32 where JAX keeps int64, cost and counts in JAX's dtypes."""
    for i, (a, b) in enumerate(zip(got, want)):
        if i < 2:
            assert a.dtype == np.int32 and b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        else:
            _same(a, b)


def _edges(kind):
    """RMAT-8 with repeated records and self-loops, or a 12x12 road."""
    if kind == "rmat":
        n, e = generators.rmat_edges(8, edge_factor=8, seed=1)
        e = np.concatenate([e, e[:40], [[3, 3], [7, 7], [3, 3]]]).astype(np.int32)
        return n, e
    return generators.road_edges(12, 12, seed=2)


def _costs(m, dist="uniform", seed=3):
    return generators.edge_costs(m, dist, 16, seed=seed)


FLAVORS = ["bitbell", "stencil", "mesh2d"]


# ---------------------------------------------------------------------------
# The cost column
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dist", ["uniform", "zipf"])
def test_edge_costs_match_jax(dist):
    for m, seed in ((0, 0), (1000, 5)):
        _same(generators.edge_costs(m, dist, 16, seed=seed),
              jgen.edge_costs(m, dist, 16, seed=seed))
    with pytest.raises(ValueError, match="unknown cost distribution"):
        generators.edge_costs(3, "pareto")


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["rmat", "road"])
def test_weighted_csr_and_dedup_match_jax(kind, native):
    n, e = _edges(kind)
    w = _costs(len(e), "zipf")
    jg = JCSRGraph.from_edges(n, e, weights=w)
    g = CSRGraph.from_edges(n, e, native=native, weights=w)
    assert g.has_weights
    for a, b in ((g.row_offsets, jg.row_offsets), (g.col_indices, jg.col_indices),
                 (g.edge_weights, jg.edge_weights)):
        _same(a, b)
    _same_dedup(g.deduped_weighted(native), jg.deduped_weighted())
    # The JAX bitbell flavor's slots (its BellGraph's sparse arrays) are
    # these dedup arrays: the port builds no forest for them.
    bell = JBellGraph.from_host(jg)
    _, count, vals = bell.sparse
    u, v, wd, deg = g.deduped_weighted(native)
    np.testing.assert_array_equal(np.asarray(count), deg)
    np.testing.assert_array_equal(np.asarray(vals), v)
    np.testing.assert_array_equal(np.asarray(bell.sparse_weights), wd)


@pytest.mark.parametrize("native", [True, False])
def test_weighted_from_edges_edge_cases_match_jax(native):
    for n, e in ((5, np.zeros((0, 2), np.int32)), (3, np.array([[1, 1], [2, 2]])),
                 (0, np.zeros((0, 2), np.int32))):
        w = np.ones(len(e), np.int32)
        g = CSRGraph.from_edges(n, e, native=native, weights=w)
        jg = JCSRGraph.from_edges(n, e, weights=w)
        _same(g.edge_weights, jg.edge_weights)
        _same_dedup(g.deduped_weighted(native), jg.deduped_weighted())
    for bad, msg in (([1, 0], "must be >= 1"), ([1], "must be \\(2,\\)")):
        with pytest.raises(ValueError, match=msg):
            CSRGraph.from_edges(3, [[0, 1], [1, 2]], native=native, weights=bad)
    with pytest.raises(ValueError, match="needs edge_weights"):
        CSRGraph.from_edges(3, [[0, 1]], native=native).deduped_weighted(native)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("kind", ["rmat", "road"])
def test_weighted_bin_round_trip_matches_jax(tmp_path, kind, native):
    n, e = _edges(kind)
    w = _costs(len(e))
    path = tmp_path / "w.bin"
    tio.save_graph_bin(path, n, e, w)
    got = tio.load_graph_bin(path, native=native)
    want = jio.load_graph_bin(path, native=False)
    for a, b in ((got.row_offsets, want.row_offsets), (got.col_indices, want.col_indices),
                 (got.edge_weights, want.edge_weights)):
        _same(a, b)
    # A weightless file stays weightless.
    tio.save_graph_bin(tmp_path / "u.bin", n, e)
    assert not tio.load_graph_bin(tmp_path / "u.bin", native=native).has_weights


@pytest.mark.parametrize("native", [True, False])
def test_weighted_bin_truncations_fail_as_jax(tmp_path, native):
    n, e = _edges("road")
    path = tmp_path / "w.bin"
    tio.save_graph_bin(path, n, e, _costs(len(e)))
    blob = path.read_bytes()
    edge_end = 12 + 8 * len(e)
    cuts = {"mid_magic": blob[: edge_end + 2], "mid_costs": blob[: edge_end + 4 + 2 * len(e)],
            "one_short": blob[:-1], "long": blob + b"xx",
            "magic": blob[:edge_end] + b"XSBW" + blob[edge_end + 4:]}
    for name, data in cuts.items():
        bad = tmp_path / f"{name}.bin"
        bad.write_bytes(data)
        with pytest.raises(IOError) as want:
            jio.load_graph_bin(bad, native=False)
        with pytest.raises(IOError) as got:
            tio.load_graph_bin(bad, native=native)
        assert str(got.value) == str(want.value), name


# ---------------------------------------------------------------------------
# The relaxation pass: K12's plain version against JAX's scatter-min
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("light", [True, False])
@pytest.mark.parametrize("k", [1, 5])
def test_relax_plain_matches_jax(k, light):
    # JAX's pass on (K, n) planes; the port's on the same planes transposed
    # to its query-minor (n, K) layout.
    n, e = _edges("rmat")
    g = CSRGraph.from_edges(n, e, weights=_costs(len(e)))
    u, v, w, _ = g.deduped_weighted()
    rng = np.random.default_rng(9 + k)
    tent = np.where(rng.random((k, n)) < 0.4, rng.integers(0, 60, (k, n)),
                    cuda_weighted.INF).astype(np.int32)
    active = (rng.random((k, n)) < 0.3) & (tent < cuda_weighted.INF)
    delta = 7
    sel = (w <= delta) if light else (w > delta)
    want = np.asarray(jds._relax_scatter_min(
        tent, active, u.astype(np.int32), v.astype(np.int32), w, sel))
    slots = [torch.from_numpy(a.astype(np.int32)) for a in (u, v, w)]
    t, a = torch.from_numpy(tent.T.copy()), torch.from_numpy(active.T.copy())
    keep = sel
    side = cuda_weighted.make_side(u[keep], v[keep], w[keep], "cpu")
    for chunk in (cuda_weighted.PLAIN_CHUNK_CELLS, 7):
        got = cuda_weighted.relax_plain(t, a, *slots, delta, light, chunk_cells=chunk)
        np.testing.assert_array_equal(got.numpy().T, want)
    # The wrapper on a CPU tensor runs the plain version over the side.
    got = cuda_weighted.relax(t, a, side, 0, side.num_pieces, delta, light)
    np.testing.assert_array_equal(got.numpy().T, want)
    # A row band: its slots alone offer, on the side and on the whole range.
    lo, hi = n // 4, n // 2
    part = sel & (u >= lo) & (u < hi)
    want = np.asarray(jds._relax_scatter_min(
        tent, active, u.astype(np.int32), v.astype(np.int32), w, part))
    p0, p1 = np.searchsorted(side.host_pieces[:, 2], (lo, hi))
    got = cuda_weighted.relax(t, a, side, int(p0), int(p1), delta, light)
    np.testing.assert_array_equal(got.numpy().T, want)
    s0, s1 = np.searchsorted(u, (lo, hi))
    got = cuda_weighted.relax_plain(t, a, *slots, delta, light, int(s0), int(s1))
    np.testing.assert_array_equal(got.numpy().T, want)


@pytest.mark.parametrize("k, aligned, want", [
    (1, True, (1, 1)), (5, True, (1, 8)), (8, True, (4, 2)), (8, False, (1, 8)),
    (64, True, (4, 16)), (200, True, (4, 32)), (1000, False, (1, 32)),
])
def test_relax_plan(k, aligned, want):
    assert cuda_weighted.relax_plan(k, aligned) == want


@pytest.mark.parametrize("threads", [None, "3"])
@pytest.mark.parametrize("case", ["empty", "one_slot_pieces", "cuts", "hub"])
def test_row_pieces_native_matches_numpy(monkeypatch, case, threads):
    # Three threads cut the slots mid-run and mid-piece.
    if threads:
        monkeypatch.setenv("MSBFS_NATIVE_THREADS", threads)
    rng = np.random.default_rng(3)
    rows, slots, cuts = np.zeros(0, np.int32), 4, None
    if case == "one_slot_pieces":
        rows, slots = np.sort(rng.integers(0, 9, 50)).astype(np.int32), 1
    elif case == "cuts":
        # Four segments, each sorted by row on its own; two cuts coincide.
        rows = np.concatenate([np.sort(rng.integers(0, 20, k)) for k in (30, 0, 41, 17)])
        cuts = np.array([0, 30, 30, 71, 88])
    elif case == "hub":
        rows = np.repeat(np.arange(6), [3, 0, 200, 1, 65, 64]).astype(np.int32)
    want = csr_mod.row_pieces(rows, slots, cuts, native=False)
    _same(csr_mod.row_pieces(rows, slots, cuts), want)
    if rows.size:
        assert want[0, 0] == 0 and want[-1, 1] == rows.size
        assert (want[:, 1] - want[:, 0] <= slots).all()
    # The native split by cost keeps each side in slot order.
    v = rng.integers(0, 99, rows.size).astype(np.int32)
    w = rng.integers(1, 17, rows.size).astype(np.int32)
    light = w <= 8
    for got, keep in zip(native_loader.split_slots(rows, v, w, 8), (light, ~light)):
        for a, b in zip(got, (rows[keep], v[keep], w[keep])):
            _same(a, b.astype(np.int32))


def _hub_graph():
    """RMAT-8 plus a hub: vertex 0 joined to 200 others, a row of more
    than three pieces."""
    n, e = _edges("rmat")
    hub = np.stack([np.zeros(200, np.int64), np.arange(1, 201)], axis=1)
    e = np.concatenate([e, hub]).astype(np.int32)
    return n, e, _costs(len(e), seed=6)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("delta", [None, 1, 17])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_sides_and_pieces(flavor, delta, native):
    n, e, w = _hub_graph()
    g = CSRGraph.from_edges(n, e, weights=w)
    _, eng = tw.negotiate_weighted_engine(g, flavor, delta, device="cpu", native=native)
    P = cuda_weighted.PIECE_SLOTS
    u, v, w, _ = g.deduped_weighted()
    assert np.bincount(u).max() > 3 * P  # the hub row
    got = []
    for light, side in zip((True, False), eng._sides):
        su, sv, sw = (x.numpy() for x in (side.u, side.v, side.w))
        assert ((sw <= eng.delta) == light).all()
        pcs = side.host_pieces
        np.testing.assert_array_equal(pcs, side.pieces.numpy())
        # The pieces tile the side's slots, in order, none longer than P,
        # each within one row.
        if pcs.size:
            assert pcs[0, 0] == 0 and pcs[-1, 1] == su.size
            np.testing.assert_array_equal(pcs[1:, 0], pcs[:-1, 1])
        assert ((pcs[:, 1] > pcs[:, 0]) & (pcs[:, 1] - pcs[:, 0] <= P)).all()
        for s0, s1, owner in pcs:
            assert (su[s0:s1] == owner).all()
        got.append(np.stack([su, sv, sw], axis=1))
        if flavor == "mesh2d":
            # A tile's pieces are one run: its slots, in row order.
            bounds = eng._tile_pieces[0 if light else 1]
            for t in range(eng.tiles):
                s0, s1 = side.slot_range(int(bounds[t]), int(bounds[t + 1]))
                tile_v = sv // eng.tile == t
                assert tile_v[s0:s1].all() and tile_v.sum() == s1 - s0
                assert (np.diff(pcs[bounds[t]:bounds[t + 1], 2]) >= 0).all()
        else:
            assert (np.diff(pcs[:, 2]) >= 0).all()
            # A row band's pieces are one run: its slots, nothing else.
            for lo, hi in ((0, 1), (3, n // 2), (n // 3, n)):
                p0, p1 = np.searchsorted(pcs[:, 2], (lo, hi))
                s0, s1 = side.slot_range(int(p0), int(p1))
                in_band = (su >= lo) & (su < hi)
                assert in_band[s0:s1].all() and in_band.sum() == s1 - s0
    # Each slot of the flavor appears on exactly one side, once; the two
    # sides' widths sum to the flavor's range.
    both = np.concatenate(got)
    assert len(both) == eng._u_host.size
    want = np.stack([u, v, w], axis=1)
    _same(np.unique(both, axis=0), np.unique(want, axis=0).astype(np.int32))
    if native:  # the native split gives the NumPy split's bytes
        _, ref = tw.negotiate_weighted_engine(g, flavor, delta, device="cpu", native=False)
        for a, b in zip(eng._sides, ref._sides):
            for x, y in zip(a, b):
                _same(np.asarray(x), np.asarray(y))
    if flavor == "stencil":
        lo, hi = 3, n // 2
        width = sum(np.diff(s.slot_range(*(int(p) for p in np.searchsorted(
            s.host_pieces[:, 2], (lo, hi))))) for s in eng._sides)
        assert width == eng._slot_start[hi] - eng._slot_start[lo]


# ---------------------------------------------------------------------------
# The drive loop, every flavor, against JAX's engines
# ---------------------------------------------------------------------------



def _engines(g, jg, flavor, delta=None):
    _, t = tw.negotiate_weighted_engine(g, flavor, delta, device="cpu")
    _, j = jw.negotiate_weighted_engine(jg, flavor, delta)
    return t, j


@pytest.mark.parametrize("delta", ["auto", "knob1", "above_max"])
@pytest.mark.parametrize("dist", ["uniform", "zipf"])
@pytest.mark.parametrize("flavor", FLAVORS)
def test_flavors_match_jax(monkeypatch, flavor, dist, delta):
    n, e = _edges("rmat")
    w = _costs(len(e), dist, seed=4)
    g, jg = CSRGraph.from_edges(n, e, weights=w), JCSRGraph.from_edges(n, e, weights=w)
    queries = generators.random_queries(n, 6, max_group=4, seed=5)
    queries[2] = np.zeros(0, np.int32)
    queries[4] = np.array([-3, n + 7], np.int32)  # out of range only
    rows = tio.pad_queries(queries)
    ctor = None
    if delta == "knob1":
        monkeypatch.setenv("MSBFS_DELTA", "1")
    elif delta == "above_max":
        ctor = 17
    t, j = _engines(g, jg, flavor, ctor)
    assert t.delta == j.delta
    dist_t = t.distances(rows)
    _same(dist_t, np.asarray(j.distances(rows)))
    assert t.weighted_stats() == j.weighted_stats()
    np.testing.assert_array_equal(t.f_values(rows).numpy(), np.asarray(j.f_values(rows)))
    for a, b in zip(t.query_stats(rows), j.query_stats(rows)):
        _same(a, b)
    assert t.best(rows) == tuple(int(x) for x in j.best(rows))
    # The distances are Dijkstra's.
    want = np.stack([oracle_dijkstra(n, e, w, q) for q in queries])
    np.testing.assert_array_equal(dist_t, want)


def test_delta_precedence(monkeypatch):
    n, e = _edges("road")
    g = CSRGraph.from_edges(n, e, weights=_costs(len(e)))
    auto = tw.WeightedBitBellEngine(g, device="cpu").delta
    u, v, w, _ = g.deduped_weighted()
    assert auto == tw.resolve_delta(w) == jds.resolve_delta(w)
    monkeypatch.setenv("MSBFS_DELTA", "5")
    assert tw.WeightedBitBellEngine(g, device="cpu").delta == 5
    assert tw.WeightedBitBellEngine(g, delta=3, device="cpu").delta == 3
    monkeypatch.setenv("MSBFS_DELTA", "junk")
    assert tw.resolve_delta(w) == jds.resolve_delta(w) == auto
    assert tw.resolve_delta(np.zeros(0, np.int32)) == 1


@pytest.mark.parametrize("flavor", FLAVORS)
def test_edge_cases_match_jax(flavor):
    # K = 0, and a graph with no edges (sources only).
    n, e = _edges("road")
    w = _costs(len(e))
    t, j = _engines(CSRGraph.from_edges(n, e, weights=w),
                    JCSRGraph.from_edges(n, e, weights=w), flavor)
    empty = np.zeros((0, 3), np.int32)
    _same(t.distances(empty), np.asarray(j.distances(empty)))
    assert t.weighted_stats() == j.weighted_stats()
    assert t.f_values(empty).shape == (0,)
    assert t.best(empty) == (-1, -1)
    bare = np.zeros((0, 2), np.int32)
    t, j = _engines(CSRGraph.from_edges(9, bare, weights=np.zeros(0, np.int32)),
                    JCSRGraph.from_edges(9, bare, weights=np.zeros(0, np.int32)), flavor)
    rows = np.array([[0, 4], [8, -1]], np.int32)
    _same(t.distances(rows), np.asarray(j.distances(rows)))
    assert t.weighted_stats() == j.weighted_stats()


def test_overflow_guard_and_refusals_match_jax():
    n = 3
    e = np.array([[0, 1], [1, 2]], np.int32)
    w = np.array([1 << 29, 1], np.int32)
    msgs = []
    for make in (lambda: tw.WeightedBitBellEngine(CSRGraph.from_edges(n, e, weights=w),
                                                  device="cpu"),
                 lambda: jw.WeightedBitBellEngine(JCSRGraph.from_edges(n, e, weights=w))):
        with pytest.raises(Exception) as exc:
            make()
        assert type(exc.value).__name__ == "InputError"
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "int32 tentative-plane" in msgs[0]
    # A weightless graph, an unknown flavor, an engine built by hand on a
    # weightless graph: the same messages.
    weightless = (CSRGraph.from_edges(n, e), JCSRGraph.from_edges(n, e))
    weighted = (CSRGraph.from_edges(n, e, weights=[2, 3]),
                JCSRGraph.from_edges(n, e, weights=[2, 3]))
    for (tg, jg), flavor in ((weightless, None), (weighted, "bogus")):
        with pytest.raises(supervisor.InputError) as got:
            tw.negotiate_weighted_engine(tg, flavor, device="cpu")
        with pytest.raises(jsup.InputError) as want:
            jw.negotiate_weighted_engine(jg, flavor)
        assert str(got.value) == str(want.value)
    with pytest.raises(supervisor.InputError) as got:
        tw.WeightedStencilEngine(weightless[0], device="cpu")
    with pytest.raises(jsup.InputError) as want:
        jw.WeightedStencilEngine(weightless[1])
    assert str(got.value) == str(want.value)


def test_labels_and_tokens_match_jax():
    n, e = _edges("road")
    w = _costs(len(e))
    g = CSRGraph.from_edges(n, e, weights=w)
    jg = JCSRGraph.from_edges(n, e, weights=w)
    tc, jc = tw.weighted_candidates(g, device="cpu"), jw.weighted_candidates(jg)
    assert [(lab, cls.CAPABILITIES) for lab, cls, _ in tc] == [
        (lab, cls.CAPABILITIES) for lab, cls, _ in jc
    ]
    for flavor in ("auto", " Stencil ", "mesh2d", ""):
        assert tw.negotiate_weighted_engine(g, flavor, device="cpu")[0] == \
            jw.negotiate_weighted_engine(jg, flavor)[0]


# ---------------------------------------------------------------------------
# The plane seam and the audit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavor", FLAVORS)
def test_wplane_bitflip_matches_jax(flavor):
    n, e = _edges("rmat")
    w = _costs(len(e))
    t, j = _engines(CSRGraph.from_edges(n, e, weights=w),
                    JCSRGraph.from_edges(n, e, weights=w), flavor)
    rows = np.array([[0, 5], [7, 9]], dtype=np.int32)
    clean = t.distances(rows)
    with faults.injected(faults.FaultPlan.parse("bitflip:wplane:1")):
        flipped = t.distances(rows)
    with jfaults.injected(jfaults.FaultPlan.parse("bitflip:wplane:1")):
        jflipped = np.asarray(j.distances(rows))
    _same(flipped, jflipped)
    assert not np.array_equal(clean, flipped)
    assert certify.certify_weighted_distances(
        CSRGraph.from_edges(n, e, weights=w).row_offsets,
        CSRGraph.from_edges(n, e, weights=w).col_indices,
        CSRGraph.from_edges(n, e, weights=w).edge_weights, rows, flipped,
    ) != []


@pytest.mark.parametrize("case", ["transient", "persistent"])
def test_supervisor_audit_matches_jax(case):
    n, e = _edges("road")
    w = _costs(len(e))
    g, jg = CSRGraph.from_edges(n, e, weights=w), JCSRGraph.from_edges(n, e, weights=w)
    rows = np.array([[0, 5], [7, 9]], dtype=np.int32)
    plan = "bitflip:dist:1" if case == "transient" else ",".join(
        f"bitflip:dist:{i}" for i in range(1, 9))
    results = []
    for sup_mod, flt, eng, cert, graph in (
        (supervisor, faults, tw.WeightedBitBellEngine(g, device="cpu"), certify, g),
        (jsup, jfaults, jw.WeightedBitBellEngine(jg), jcertify, jg),
    ):
        with flt.injected(flt.FaultPlan.parse(plan)):
            sup = sup_mod.ChunkSupervisor(
                eng, policy=sup_mod.RetryPolicy(max_retries=1, base_delay=0.0, seed=0),
                auditor=cert.make_weighted_auditor(graph), audit_sample=1.0,
            )
            try:
                out = ("f", np.asarray(sup.f_values(rows)).tolist())
            except Exception as exc:  # the terminal verdict, compared below
                out = (type(exc).__name__, getattr(exc, "exit_code", None))
        results.append((out, sup.audited_total, sup.audit_failures_total,
                        [ev["action"] for ev in sup.events]))
    assert results[0] == results[1]
    if case == "persistent":
        assert results[0][0] == ("CorruptionError", 9)


def test_weightless_auditor_is_a_wiring_bug():
    n, e = _edges("road")
    with pytest.raises(ValueError, match="edge_weights"):
        certify.make_weighted_auditor(CSRGraph.from_edges(n, e))
