"""The port's mxu route against the JAX package's ops/mxu.py on the same
seeded inputs: generators, dedup pairs, the tile layout, one level of
each direction, the engine in every drive mode, the direction trace, the
tile-FLOP counters, the sub-batch split and the CLI.  Everything is bits
and integers, so every comparison is exact.  The JAX results are computed
once per module (fixtures) to keep the file cheap."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    generators as jgen,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    bitbell as jbb,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    engine as jengine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import mxu as jm
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    packed as jpacked,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    timing as jtiming,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    bitbell,
    cuda_mxu,
    engine,
    mxu,
    packed,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io,
    timing,
)

PORT = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Engine drive modes held against the JAX engine (same kwargs both sides).
MODES = {
    "never_push": {"switch": 0},
    "always_push": {"switch": 10**9, "push_budget": 10**9},
    "both_directions_chunked": {"switch": 40, "level_chunk": 3},
    "megachunk": {"level_chunk": 2, "megachunk": 3},
}

# benchmarks/perf_smoke.py MXU_EXPECTED_DIRECTIONS on its RMAT-8 fixture.
EXPECTED_DIRECTIONS = ["push", "matmul", "matmul", "matmul", "push"]


def _t(a):
    """numpy (u)int32 -> int32 torch tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


@pytest.fixture(scope="module")
def rmat():
    """tests/test_mxu.py's RMAT-8 fixture: an empty group and an
    all-out-of-range group among ten."""
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=801)
    queries = generators.random_queries(n, 10, max_group=6, seed=802)
    queries[3] = np.zeros(0, dtype=np.int32)
    queries[7] = np.array([-1, n + 9], dtype=np.int32)
    return n, edges, CSRGraph.from_edges(n, edges), JCSRGraph.from_edges(n, edges), io.pad_queries(queries)


@pytest.fixture(scope="module")
def jax_modes(rmat):
    """JAX (levels, reached, F) and best per drive mode, at T = 16."""
    _, _, _, jg, padded = rmat
    jmg = jm.MxuGraph.from_host(jg, tile=16)
    out = {}
    for name, kwargs in MODES.items():
        eng = jm.MxuEngine(jmg, **kwargs)
        out[name] = (eng.query_stats(padded), eng.best(padded))
    return out


@pytest.mark.parametrize("seed", [0, 1, 801])
def test_rmat_edges_match_jax(seed):
    n, edges = generators.rmat_edges(7, edge_factor=4, seed=seed)
    jn, jedges = jgen.rmat_edges(7, edge_factor=4, seed=seed, native=False)
    assert n == jn
    np.testing.assert_array_equal(edges, jedges)
    assert edges.dtype == np.int32


def test_deduped_pairs_match_jax(rmat):
    _, _, g, jg, _ = rmat
    for got, want in zip(g.deduped_pairs(), jg.deduped_pairs()):
        np.testing.assert_array_equal(got, want)
    empty = CSRGraph.from_edges(0, np.zeros((0, 2), np.int32)).deduped_pairs()
    assert [a.size for a in empty] == [0, 0, 0]


@pytest.mark.parametrize("tile", [16, 32])
def test_from_host_matches_jax(rmat, tile):
    _, _, g, jg, _ = rmat
    mg = mxu.MxuGraph.from_host(g, "cpu", tile=tile)
    jmg = jm.MxuGraph.from_host(jg, tile=tile, device=False)
    for name in ("tiles", "tile_row", "tile_col", "start", "count", "vals"):
        np.testing.assert_array_equal(getattr(mg, name).numpy(), getattr(jmg, name), name)
    assert (mg.ntr, mg.n_pad, mg.nt, mg.tiles_total, mg.level_flops) == (
        jmg.ntr, jmg.n_pad, jmg.nt, jmg.tiles_total, jmg.level_flops,
    )
    # The kernel's row pointer: row tile r's tiles at [ptr[r], ptr[r+1]).
    ptr = mg.row_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == mg.nt
    np.testing.assert_array_equal(np.repeat(np.arange(mg.ntr), np.diff(ptr)), jmg.tile_row)


def test_tile_cap_and_tile_validation(rmat):
    _, _, g, jg, _ = rmat
    with pytest.raises(ValueError) as port_err:
        mxu.MxuGraph.from_host(g, "cpu", tile=8, max_tiles=4)
    with pytest.raises(ValueError) as jax_err:
        jm.MxuGraph.from_host(jg, tile=8, max_tiles=4)
    assert str(port_err.value) == str(jax_err.value)
    assert "too tile-dense" in str(port_err.value)
    with pytest.raises(ValueError, match="multiple of 8"):
        mxu.resolve_tile(12)
    assert mxu.resolve_tile(64) == jm.resolve_tile(64) == 64


def _go(direction):
    return torch.tensor([1, 3, 0, direction], dtype=torch.int32)


def test_tile_matmul_matches_jax_and_pallas_interpret():
    """A small (nt, 16, 32) case: six tiles (two in row tile 0, none in
    row tile 1) against JAX's einsum route and its Pallas chain run in
    interpret mode."""
    rng = np.random.default_rng(7)
    t, ntr, w = 16, 3, 1
    tile_row = np.array([0, 0, 2, 2, 2, 2], dtype=np.int32)
    tile_col = np.array([0, 2, 0, 1, 1, 2], dtype=np.int32)
    tiles = (rng.random((6, t, t)) < 0.2).astype(np.int8)
    frontier = rng.integers(0, 2**32, size=(ntr * t, w), dtype=np.uint64).astype(np.uint32)
    frontier[rng.random(ntr * t) < 0.5] = 0
    args = (jnp.asarray(tiles), jnp.asarray(tile_row), jnp.asarray(tile_col), ntr)
    want = np.asarray(jm.tile_matmul_hits(*args, jnp.asarray(frontier)))
    pallas = np.asarray(jm.tile_matmul_hits(*args, jnp.asarray(frontier), kernel=True))
    np.testing.assert_array_equal(want, pallas)
    assert not want[t : 2 * t].any()  # the empty row tile writes zeros
    row_ptr = torch.tensor([0, 2, 2, 6], dtype=torch.int32)
    got = torch.full((ntr * t, w), 7, dtype=torch.int32)
    cuda_mxu.tile_matmul_hits(
        _t(tiles).view(torch.int8), _t(tile_row), _t(tile_col), row_ptr,
        _t(frontier), got, _go(bitbell.DIR_MATMUL),
    )
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bf16 = cuda_mxu.bmm_tile_hits(
        _t(tiles).view(torch.int8), _t(tile_row), _t(tile_col), ntr, _t(frontier),
        torch.bfloat16,
    )
    assert torch.equal(bf16, got)
    # Gated off (a push level, or converged): hits are left untouched.
    stale = torch.full_like(got, 7)
    for ctrl in (_go(bitbell.DIR_PUSH), torch.tensor([0, 3, 0, 0], dtype=torch.int32)):
        cuda_mxu.tile_matmul_hits_plain(
            _t(tiles).view(torch.int8), _t(tile_row), _t(tile_col), row_ptr,
            _t(frontier), stale, ctrl,
        )
        assert bool((stale == 7).all())


@pytest.mark.parametrize("w", [1, 2])
def test_level_hits_match_jax(rmat, w):
    """One level both ways on the graph's own planes: the matmul
    direction equals JAX's mxu_matmul_hits, the push equals JAX's
    sparse_hits_or, and the two agree."""
    n, _, g, jg, _ = rmat
    mg = mxu.MxuGraph.from_host(g, "cpu", tile=16)
    jmg = jm.MxuGraph.from_host(jg, tile=16)
    rng = np.random.default_rng(w)
    frontier = rng.integers(0, 2**32, size=(mg.n_pad, w), dtype=np.uint64).astype(np.uint32)
    frontier[rng.random(mg.n_pad) < 0.8] = 0
    frontier[n:] = 0
    want = np.asarray(jm.mxu_matmul_hits(jmg, jnp.asarray(frontier)))
    view = jm._PushView(n=jmg.n_pad, sparse=(jmg.start, jmg.count, jmg.vals))
    budget = jmg.n_pad + int(jmg.vals.shape[0])
    push_want = np.asarray(jbb.sparse_hits_or(jnp.asarray(frontier), view, budget))
    np.testing.assert_array_equal(push_want, want)
    for kernel in (False, True):
        got = mxu.mxu_matmul_hits(mg, _t(frontier), kernel=kernel)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # The push ORs into a zeroed plane from the frontier's worklist.
    switch = bitbell.PushSwitch.new(mg.count, mg.n_pad, 10**9, w)
    bitbell.switch_record(switch, _t(frontier), _go(bitbell.DIR_PUSH))
    pushed = torch.zeros((mg.n_pad, w), dtype=torch.int32)
    bitbell.sparse_hits_or(
        _t(frontier), mg.start, mg.vals, pushed, _go(bitbell.DIR_PUSH), switch
    )
    np.testing.assert_array_equal(pushed.numpy().view(np.uint32), want)
    stale = torch.full_like(pushed, 5)
    bitbell.sparse_hits_or_plain(
        _t(frontier), mg.start, mg.vals, stale, _go(bitbell.DIR_MATMUL), switch
    )
    assert bool((stale == 5).all())  # a matmul level: the push leaves hits


def test_frontier_activity_and_budget_match_jax(rmat):
    _, _, g, jg, _ = rmat
    rng = np.random.default_rng(3)
    frontier = rng.integers(0, 2**32, size=(300, 2), dtype=np.uint64).astype(np.uint32)
    frontier[rng.random(300) < 0.7] = 0
    counts = rng.integers(0, 50, size=300).astype(np.int32)
    got = engine.frontier_activity(_t(frontier), torch.from_numpy(counts))
    want = jengine.frontier_activity(jnp.asarray(frontier), jnp.asarray(counts))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert got[1].dtype == got[2].dtype == torch.int32
    for e in (0, 100, 1 << 20, 1 << 40):
        assert bitbell.default_sparse_budget(e) == jbb.default_sparse_budget(e)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kernel", [False, True])
def test_engine_matches_jax(rmat, jax_modes, mode, kernel):
    _, _, g, _, padded = rmat
    want_stats, want_best = jax_modes[mode]
    eng = mxu.MxuEngine(mxu.MxuGraph.from_host(g, "cpu", tile=16), kernel=kernel, **MODES[mode])
    for x, y in zip(eng.query_stats(padded), want_stats):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(eng.f_values(padded).numpy(), want_stats[2])
    assert eng.best(padded) == want_best


def test_plain_engine_and_knobs(rmat, jax_modes, monkeypatch):
    _, _, g, _, padded = rmat
    mg = mxu.MxuGraph.from_host(g, "cpu", tile=16)
    plain = mxu.MxuEngine(mg, switch=40, level_chunk=3, plain=True)
    want_stats, want_best = jax_modes["both_directions_chunked"]
    for x, y in zip(plain.query_stats(padded), want_stats):
        np.testing.assert_array_equal(x, y)
    monkeypatch.setenv("MSBFS_MXU_SWITCH", "40")
    monkeypatch.setenv("MSBFS_MXU_KERNEL", "1")
    eng = mxu.MxuEngine(mg, push_budget=10**9)
    assert eng.switch == 40 and eng.kernel
    assert eng.push_budget == mg.n_pad + int(mg.vals.shape[0])
    monkeypatch.delenv("MSBFS_MXU_SWITCH")
    monkeypatch.delenv("MSBFS_MXU_KERNEL")
    eng = mxu.MxuEngine(mg)
    assert eng.switch == max(1, mg.n // 64) and not eng.kernel


def test_direction_trace_pins_perf_smoke():
    """perf_smoke.py run_mxu's fixture (RMAT-8, T = 16, switch = 40, K = 16
    groups of at most 4): thin start pushes, dense middle matmuls, thin
    drain pushes — the same trace as the JAX engine."""
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=801)
    q = io.pad_queries(generators.random_queries(n, 16, max_group=4, seed=45), pad_to=4)
    eng = mxu.MxuEngine(mxu.MxuGraph.from_host(CSRGraph.from_edges(n, edges), "cpu", tile=16), switch=40)
    trace = eng.level_direction_trace(q)
    assert [s["direction"] for s in trace] == EXPECTED_DIRECTIONS
    assert trace is eng.last_direction_trace
    jeng = jm.MxuEngine(jm.MxuGraph.from_host(JCSRGraph.from_edges(n, edges), tile=16), switch=40)
    assert trace == jeng.level_direction_trace(q)


@pytest.mark.parametrize("switch,kernel", [(40, False), (40, True), (None, True), (0, True)])
def test_device_directions_equal_jax_trace(switch, kernel):
    """The direction each level takes on the device — ctrl[3] before each
    single-level chunk, written by the apply of the level before (the
    sources' at the carry's start) — equals the JAX engine's
    level_direction_trace, and the push's hit plane is zero between
    levels."""
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=801)
    q = io.pad_queries(generators.random_queries(n, 16, max_group=4, seed=45), pad_to=4)
    eng = mxu.MxuEngine(mxu.MxuGraph.from_host(CSRGraph.from_edges(n, edges), "cpu", tile=16),
                        switch=switch, kernel=kernel)
    carry = eng._init_carry(eng._pad_queries(q)[0])
    hits = torch.zeros_like(carry.frontier)
    seen = []
    while bitbell.level_go(carry.ctrl, 10**6):
        seen.append("push" if int(carry.ctrl[3]) == bitbell.DIR_PUSH else "matmul")
        eng._chunk(carry, 1, hits)
        assert not bool(carry.switch.hits.any())
    jeng = jm.MxuEngine(jm.MxuGraph.from_host(JCSRGraph.from_edges(n, edges), tile=16),
                        switch=switch)
    want = [s["direction"] for s in jeng.level_direction_trace(q)]
    assert seen == want
    if switch == 40:
        assert seen == EXPECTED_DIRECTIONS


def test_tile_flop_counters_match_jax(rmat):
    _, _, g, jg, padded = rmat
    eng = mxu.MxuEngine(mxu.MxuGraph.from_host(g, "cpu", tile=16), switch=0, level_chunk=1, megachunk=1)
    jeng = jm.MxuEngine(jm.MxuGraph.from_host(jg, tile=16), switch=0, level_chunk=1, megachunk=1)
    jeng.compile(padded.shape)
    timing.reset_mxu_tiles()
    jtiming.reset_mxu_tiles()
    assert eng.best(padded) == jeng.best(padded)
    eng.f_values(padded)
    jeng.f_values(padded)
    counts = timing.mxu_tile_counts()
    assert counts == jtiming.mxu_tile_counts()
    assert counts[0] > 0 and counts[2] % eng.graph.tiles_total == 0
    timing.reset_mxu_tiles()
    assert timing.mxu_tile_counts() == (0, 0, 0)


def test_k320_subbatch_matches_jax(rmat):
    n, _, g, jg, _ = rmat
    queries = io.pad_queries(generators.random_queries(n, 320, max_group=4, seed=1220))
    teng = packed.SubBatchEngine(
        mxu.MxuEngine(mxu.MxuGraph.from_host(g, "cpu", tile=16), level_chunk=4, kernel=True),
        batch_k=256,
    )
    winner = int(np.argmin(teng.f_values(queries).numpy()))
    assert winner < 256
    queries[300] = queries[winner]  # a tie across sub-batches: the first wins
    jeng = jpacked.SubBatchEngine(jm.MxuEngine(jm.MxuGraph.from_host(jg, tile=16), level_chunk=4), batch_k=256)
    want = jeng.query_stats(queries)
    for x, y in zip(teng.query_stats(queries), want):
        np.testing.assert_array_equal(x, y)
    assert teng.best(queries) == (int(want[2][winner]), winner)


def _cli_fixture(tmp_path):
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=31)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, 40, max_group=5, seed=32))
    return ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]


@pytest.mark.parametrize(
    "env",
    [
        {"MSBFS_MXU_KERNEL": "1"},
        {},
        {"MSBFS_MXU_KERNEL": "1", "MSBFS_MXU_TILE": "32", "MSBFS_LEVEL_CHUNK": "2"},
    ],
)
def test_cli_mxu_route_matches_jax(tmp_path, capsys, monkeypatch, env):
    """Winner and F of the port's CLI on the mxu route equal the JAX
    CLI's (which runs its einsum route: the same function)."""
    argv = _cli_fixture(tmp_path)
    monkeypatch.setenv("MSBFS_BACKEND", "mxu")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert cli.main(argv, device="cpu") == 0
    port = capsys.readouterr().out.splitlines()
    monkeypatch.delenv("MSBFS_MXU_KERNEL", raising=False)
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out.splitlines()
    assert len(port) == 7 and port[:5] == want[:5]


def test_cli_tile_cap_matches_jax(tmp_path, capsys, monkeypatch):
    argv = _cli_fixture(tmp_path)
    monkeypatch.setenv("MSBFS_BACKEND", "mxu")
    monkeypatch.setenv("MSBFS_MXU_TILE", "8")
    monkeypatch.setenv("MSBFS_MXU_MAX_TILES", "4")
    assert cli.main(argv, device="cpu") == 1
    port = capsys.readouterr()
    assert jcli.main(argv) == 1
    want = capsys.readouterr()
    assert port.out == want.out == ""
    assert port.err.strip() == want.err.strip()
    assert "too tile-dense" in port.err


def test_wrappers_reject_bad_inputs(rmat):
    _, _, g, _, _ = rmat
    mg = mxu.MxuGraph.from_host(g, "cpu", tile=16)
    fr = torch.zeros((mg.n_pad, 1), dtype=torch.int32)
    args = (mg.tiles, mg.tile_row, mg.tile_col, mg.row_ptr)
    with pytest.raises(ValueError, match="int8"):
        cuda_mxu.tile_matmul_hits(mg.tiles.float(), *args[1:], fr, fr.clone(), _go(0))
    with pytest.raises(ValueError, match="shape"):
        cuda_mxu.tile_matmul_hits(*args, fr[:-1], fr.clone(), _go(0))
    switch = bitbell.PushSwitch.new(mg.count, 8, 8, 1)
    with pytest.raises(TypeError, match="int32"):
        bitbell.sparse_hits_or(fr, mg.start.long(), mg.vals, fr.clone(), _go(1), switch)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        f"import {PORT}.ops.mxu, {PORT}.ops.cuda_mxu, {PORT}.ops.bitbell, {PORT}.cli\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu']\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
