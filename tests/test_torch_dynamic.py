"""The port's dynamic graphs (dynamic/, models/generators.py
``delta_batches``) against the JAX package's: the same seeded delta
batches, the same canonical batches and digest chain, patched CSRs
bit-identical to a from-scratch rebuild (natively and with NumPy) and to
JAX's, delta files that each package reads from the other, and repaired
distance planes equal to JAX's ``repair_distances`` /
``repair_weighted_distances`` and to a cold recompute, over seeded fuzz
cases (the cost model's fallback too)."""

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.dynamic import (
    delta as jdelta,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.dynamic import (
    repair as jrepair,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    generators as jgen,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.dynamic import (
    delta,
    repair,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    certify,
)

BASE = "0123456789ab"


def _graph(kind, seed, weighted):
    if kind == "road":
        n, edges = generators.road_edges(14, 14, seed=seed)
    else:
        n, edges = generators.gnm_edges(150, 420, seed=seed)
    w = generators.edge_costs(edges.shape[0], "uniform", 9, seed=seed) if weighted else None
    return n, edges, w


def _logs(n, edges, w, batches):
    """(port log, JAX log) over the same base graph with ``batches``
    appended; returns the logs and each package's appended batches."""
    g = CSRGraph.from_edges(n, edges, weights=w)
    jg = JCSRGraph.from_edges(n, edges, weights=w) if w is not None else JCSRGraph.from_edges(n, edges)
    log, jlog = delta.DeltaLog.from_graph(g, BASE), jdelta.DeltaLog.from_graph(jg, BASE)
    mine = [log.append(i, d) for i, d in batches]
    theirs = [jlog.append(i, d) for i, d in batches]
    return log, jlog, mine, theirs


@pytest.mark.parametrize("locality", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_delta_batches_match_jax(seed, locality):
    n, edges, _ = _graph("gnm", seed, False)
    mine = generators.delta_batches(n, edges, batches=4, batch_size=9,
                                    locality=locality, insert_frac=0.4, seed=seed)
    theirs = jgen.delta_batches(n, edges, batches=4, batch_size=9,
                                locality=locality, insert_frac=0.4, seed=seed)
    assert len(mine) == len(theirs) == 4
    for (a, b), (c, d) in zip(mine, theirs):
        assert np.array_equal(a, c) and a.dtype == c.dtype
        assert np.array_equal(b, d) and b.dtype == d.dtype


@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weighted"])
@pytest.mark.parametrize("kind,seed", [("road", 1), ("gnm", 2), ("gnm", 5)])
def test_digest_chain_and_apply_match_jax(kind, seed, weighted):
    n, edges, w = _graph(kind, seed, weighted)
    batches = generators.delta_batches(n, edges, batches=3, batch_size=12,
                                       locality=0.7, seed=seed)
    # A batch that names one pair in both lists, a self-loop and a repeat.
    batches.append(([[1, 2], [3, 3], [2, 1]], [[1, 2], [4, 5]]))
    log, jlog, mine, theirs = _logs(n, edges, w, batches)
    assert [b.digest for b in mine] == [b.digest for b in theirs]
    for a, b in zip(mine, theirs):
        assert a.version == b.version
        assert np.array_equal(a.inserts, b.inserts) and np.array_equal(a.deletes, b.deletes)
    for v in range(log.version + 1):
        assert log.digest(v) == jlog.digest(v)
        assert np.array_equal(log.keys_at(v), jlog.keys_at(v))
    for span in ((0, 4), (1, 3), (2, 2)):
        for x, y in zip(log.net_delta(*span), jlog.net_delta(*span)):
            assert np.array_equal(x, y)
    # apply(): the JAX package's CSR, and a from-scratch rebuild on the
    # canonical edge list, natively and with NumPy.
    jg, jid = jlog.apply()
    pairs = delta.keys_to_pairs(log.keys_at())
    for native in (True, False):
        g, ident = log.apply(native=native)
        assert ident == jid == (BASE, 4)
        scratch = CSRGraph.from_edges(
            n, pairs, native=native,
            weights=log._weights_for(log.keys_at()) if weighted else None)
        for got in (jg, scratch):
            assert np.array_equal(g.row_offsets, got.row_offsets)
            assert np.array_equal(g.col_indices, got.col_indices)
            if weighted:
                assert np.array_equal(g.edge_weights, got.edge_weights)
            else:
                assert g.edge_weights is None


@pytest.mark.parametrize("direction", ["port_writes", "jax_writes"])
def test_delta_files_cross_packages(tmp_path, direction):
    n, edges, _ = _graph("gnm", 4, False)
    batches = generators.delta_batches(n, edges, batches=3, batch_size=10, seed=4)
    batches.append(([[7, 7], [9, 8]], [[8, 9]]))
    path = str(tmp_path / "d.bin")
    save, load = ((delta.save_delta_bin, jdelta.load_delta_bin)
                  if direction == "port_writes"
                  else (jdelta.save_delta_bin, delta.load_delta_bin))
    save(path, n, batches)
    other = str(tmp_path / "other.bin")
    (jdelta if direction == "port_writes" else delta).save_delta_bin(other, n, batches)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    got_n, got = load(path)
    assert got_n == n and len(got) == len(batches)
    for (a, b), (ins, dels) in zip(got, batches):
        ik, dk = delta.canonicalize_batch(ins, dels, n)
        assert np.array_equal(a, delta.keys_to_pairs(ik))
        assert np.array_equal(b, delta.keys_to_pairs(dk))


@pytest.mark.parametrize("mangle", ["magic", "truncated", "huge_count", "header"])
def test_corrupt_delta_files_fail_as_jax(tmp_path, mangle):
    path = str(tmp_path / "d.bin")
    delta.save_delta_bin(path, 20, [([[1, 2]], [[3, 4]])])
    raw = bytearray(open(path, "rb").read())
    if mangle == "magic":
        raw[:4] = b"XXXX"
    elif mangle == "truncated":
        raw = raw[:-3]
    elif mangle == "huge_count":
        raw[16:24] = (1 << 40).to_bytes(8, "little")
    else:
        raw = raw[:10]
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError) as mine:
        delta.load_delta_bin(path)
    with pytest.raises(IOError) as theirs:
        jdelta.load_delta_bin(path)
    assert str(mine.value) == str(theirs.value)


def _fuzz_case(kind, seed, weighted, locality):
    """(old graph, new graph, rows, old plane, net inserts, net deletes)."""
    n, edges, w = _graph(kind, seed, weighted)
    rng = np.random.default_rng(seed)
    rows = np.full((5, 4), -1, dtype=np.int32)
    for i in range(5):
        s = int(rng.integers(1, 5))
        rows[i, :s] = rng.integers(0, n, size=s)
    batches = generators.delta_batches(n, edges, batches=2, batch_size=14,
                                       locality=locality, seed=seed)
    log, _, _, _ = _logs(n, edges, w, batches)
    old, _ = log.apply(0)
    new, _ = log.apply()
    if weighted:
        plane = certify.reference_weighted_distances(
            old.row_offsets, old.col_indices, old.edge_weights, rows)
    else:
        plane = certify.reference_distances(old.row_offsets, old.col_indices, rows)
    ins, dels = log.net_delta(0)
    return old, new, rows, plane, ins, dels


@pytest.mark.parametrize("max_frac", [None, 1e-6], ids=["cost_model", "forced_fallback"])
@pytest.mark.parametrize("kind,seed,locality", [
    ("road", 0, 0.95), ("road", 7, 0.8), ("gnm", 1, 0.9), ("gnm", 8, 0.3),
])
def test_repair_matches_jax_and_cold_recompute(kind, seed, locality, max_frac):
    old, new, rows, plane, ins, dels = _fuzz_case(kind, seed, False, locality)
    jnew = JCSRGraph(n=new.n, m=new.m, row_offsets=new.row_offsets,
                     col_indices=new.col_indices)
    dist, stats = repair.repair_distances(new, rows, plane, ins, dels, max_frac=max_frac)
    jdist, jstats = jrepair.repair_distances(jnew, rows, plane, ins, dels, max_frac=max_frac)
    assert np.array_equal(dist, jdist) and dist.dtype == jdist.dtype
    assert stats.as_dict() == jstats.as_dict()
    cold = certify.reference_distances(new.row_offsets, new.col_indices, rows)
    assert np.array_equal(dist, cold)
    if max_frac is not None:
        assert stats.fallback


@pytest.mark.parametrize("max_frac", [None, 1e-6], ids=["cost_model", "forced_fallback"])
@pytest.mark.parametrize("kind,seed,locality", [("road", 2, 0.95), ("gnm", 3, 0.8), ("road", 6, 0.5)])
def test_weighted_repair_matches_jax_and_cold_recompute(kind, seed, locality, max_frac):
    old, new, rows, plane, ins, dels = _fuzz_case(kind, seed, True, locality)
    jnew = JCSRGraph(n=new.n, m=new.m, row_offsets=new.row_offsets,
                     col_indices=new.col_indices, edge_weights=new.edge_weights)
    dist, stats = repair.repair_weighted_distances(new, rows, plane, ins, dels, max_frac=max_frac)
    jdist, jstats = jrepair.repair_weighted_distances(jnew, rows, plane, ins, dels,
                                                      max_frac=max_frac)
    assert np.array_equal(dist, jdist)
    assert stats.as_dict() == jstats.as_dict()
    cold = certify.reference_weighted_distances(
        new.row_offsets, new.col_indices, new.edge_weights, rows)
    assert np.array_equal(dist, cold)


def test_repair_cost_model_and_knob_match_jax(monkeypatch, capsys):
    args = (1 << 16, 64, 12, 300, 80, 6.5)
    assert repair.repair_cost_estimate(*args) == jrepair.repair_cost_estimate(*args)
    monkeypatch.setenv("MSBFS_REPAIR_MAX_FRAC", "lots")
    assert repair._max_frac() == jrepair._max_frac() == 0.5
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and err[0] == err[1]
    monkeypatch.setenv("MSBFS_REPAIR_MAX_FRAC", "0.25")
    assert repair._max_frac() == jrepair._max_frac() == 0.25
