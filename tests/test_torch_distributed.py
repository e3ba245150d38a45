"""The port's mesh, collectives and query-sharded engines against the JAX
package's on the 8-device virtual CPU mesh: the JAX engine runs on
``make_mesh(..., devices=jax.devices()[:P])``, its port on a logical CPU
mesh of the same shape (every entry ``cpu``).  F vectors, ``best()``, the
per-query and per-level stats must be equal (integers: zero tolerance).
Also the CLI at ``-gn 4`` (``mesh_devices``) against JAX's CLI at ``-gn 4``
on its routes and knobs, and survivor resharding under
``MSBFS_FAULTS=chip:rank1:1``."""

import contextlib
import io as _io
import re

import jax
import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    distributed as jdist,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    mesh as jmesh,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.parallel import (
    scheduler as jsched,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    supervisor as jsup,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel import (
    collectives,
    mesh,
    scheduler,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.parallel.distributed import (
    DistributedEngine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    supervisor,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
    timing,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _pad(queries):
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.io import (
        pad_queries,
    )

    return np.asarray(pad_queries(queries))


@pytest.fixture(scope="module")
def problem():
    n, edges = generators.rmat_edges(8, 8, seed=401)
    queries = generators.random_queries(n, 13, max_group=5, seed=402)
    queries[4] = np.zeros(0, dtype=np.int32)
    return n, edges, _pad(queries), JCSRGraph.from_edges(n, edges), CSRGraph.from_edges(n, edges)


def _meshes(q, v):
    return (jmesh.make_mesh(q, v, devices=jax.devices()[: q * v]),
            mesh.make_mesh(q, v, devices=["cpu"] * (q * v)))


# ---- mesh, collectives, scheduler, counter -----------------------------------


def test_mesh_shapes_and_specs_match_jax():
    for q, v in [(4, 1), (2, 2), (1, 4), (2, 4)]:
        jm, pm = _meshes(q, v)
        assert dict(jm.shape) == pm.shape and pm.axis_names == ("q", "v")
        assert pm.size == q * v and pm.distinct_devices() == [torch.device("cpu")]
    m2 = mesh.make_mesh2d(2, 3, devices=["cpu"] * 6)
    assert m2.shape == {"r": 2, "c": 3}
    for spec in ("4x2", "4X2", " 1x8 "):
        assert mesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    for bad in ("4", "4x", "ax2", "0x2", "2x-1"):
        with pytest.raises(ValueError):
            mesh.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            jmesh.parse_mesh_spec(bad)
    assert mesh.default_mesh(3, devices=["cpu"] * 8).shape == {"q": 3, "v": 1}
    with pytest.raises(ValueError):
        mesh.make_mesh(3, 1, devices=["cpu"] * 2)
    assert (mesh.QUERY_AXIS, mesh.VERTEX_AXIS, mesh.ROW_AXIS, mesh.COL_AXIS) == (
        jmesh.QUERY_AXIS, jmesh.VERTEX_AXIS, jmesh.ROW_AXIS, jmesh.COL_AXIS)


def test_collectives_share_one_buffer_on_a_shared_device():
    base = torch.arange(24, dtype=torch.int32).view(6, 4)
    parts = [base[0:2], base[2:4], base[4:6]]
    gathered = collectives.all_gather(parts)
    # One result for the device, made as a mesh of distinct cards makes
    # it: a new buffer, never a view of the parts.
    assert all(g is gathered[0] for g in gathered)
    assert gathered[0].data_ptr() != base.data_ptr()
    torch.testing.assert_close(gathered[0], base)
    stacked = collectives.all_gather(parts, tiled=False)
    assert all(g is stacked[0] for g in stacked)
    assert stacked[0].shape == (3, 2, 4) and stacked[0].data_ptr() != base.data_ptr()
    torch.testing.assert_close(stacked[0], base.view(3, 2, 4))
    apart = [torch.tensor([1, 5]), torch.tensor([4, 2]), torch.tensor([3, 3])]
    torch.testing.assert_close(collectives.all_gather(apart)[1], torch.cat(apart))
    assert collectives.psum(apart)[0].tolist() == [8, 10]
    assert collectives.psum(apart)[0].dtype == torch.int64
    assert collectives.pmax(apart)[2].tolist() == [4, 5]


def test_collective_bytes_counter():
    timing.reset_collective_bytes()
    timing.record_collective_bytes(12)
    timing.record_collective_bytes(30)
    assert timing.collective_bytes() == 42
    timing.reset_collective_bytes()
    assert timing.collective_bytes() == 0


@pytest.mark.parametrize("k,w,chunk", [(13, 4, None), (3, 8, None), (10, 4, 2), (0, 2, None)])
def test_shard_queries_and_merge_match_jax(k, w, chunk):
    queries = np.arange(k * 2, dtype=np.int32).reshape(k, 2)
    jm, pm = _meshes(w, 1)
    jgrid, jk, jk_pad, jchunk = jsched.shard_queries(jm, queries, chunk)
    grid, pk, pk_pad, pchunk = scheduler.shard_queries(pm, queries, chunk)
    np.testing.assert_array_equal(grid, np.asarray(jgrid))
    assert (pk, pk_pad, pchunk) == (jk, jk_pad, jchunk)
    j = grid.shape[1]
    # Each shard's values: its global ids + 100, merged as JAX merges.
    parts = [torch.as_tensor(r + np.arange(j) * w + 100) for r in range(w)]
    merged = scheduler.merge_local_f(parts, j, w, k, pk_pad)
    want = np.where(np.arange(pk_pad) < k, np.arange(pk_pad) + 100, -1)
    for m in merged:
        np.testing.assert_array_equal(m.numpy(), want)


# ---- DistributedEngine ---------------------------------------------------------


@pytest.mark.parametrize("q,v,level_chunk", [(4, 1, None), (2, 1, 2), (2, 2, 3)])
def test_distributed_bitbell_matches_jax(problem, q, v, level_chunk):
    n, edges, padded, jg, g = problem
    jm, pm = _meshes(q, v)
    je = jdist.DistributedEngine(jm, jg, level_chunk=level_chunk)
    pe = DistributedEngine(pm, g, level_chunk=level_chunk)
    np.testing.assert_array_equal(pe.f_values(padded).numpy(), np.asarray(je.f_values(padded)))
    assert tuple(pe.best(padded)) == tuple(int(x) for x in je.best(padded))
    for a, b in zip(pe.query_stats(padded), je.query_stats(padded)):
        np.testing.assert_array_equal(a, np.asarray(b))
    pl, jl = pe.level_stats(padded), je.level_stats(padded)
    for a, b in zip(pl[:4], jl[:4]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert len(pl[4]) == len(jl[4])


@pytest.mark.parametrize("q,chunk", [(4, None), (2, 3)])
def test_distributed_csr_matches_jax(problem, q, chunk):
    n, edges, padded, jg, g = problem
    jm, pm = _meshes(q, 1)
    je = jdist.DistributedEngine(jm, jg, backend="csr", query_chunk=chunk)
    pe = DistributedEngine(pm, g, backend="csr", query_chunk=chunk)
    np.testing.assert_array_equal(pe.f_values(padded).numpy(), np.asarray(je.f_values(padded)))
    assert pe.query_stats(padded) is None and pe.level_stats is None


def test_distributed_fewer_queries_than_shards(problem):
    n, edges, padded, jg, g = problem
    jm, pm = _meshes(8, 1)
    want = np.asarray(jdist.DistributedEngine(jm, jg).f_values(padded[:3]))
    np.testing.assert_array_equal(DistributedEngine(pm, g).f_values(padded[:3]).numpy(), want)


def test_distributed_rejects_csr_knobs(problem):
    _, _, _, _, g = problem
    pm = mesh.make_mesh(2, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        DistributedEngine(pm, g, query_chunk=2)
    with pytest.raises(ValueError):
        DistributedEngine(pm, g, backend="csr", level_chunk=4)
    with pytest.raises(ValueError):
        DistributedEngine(pm, g, backend="nope")


def test_without_ranks_reshards_to_the_same_answer(problem):
    n, edges, padded, jg, g = problem
    jm, pm = _meshes(4, 1)
    je = jdist.DistributedEngine(jm, jg).without_ranks({1, 3})
    pe = DistributedEngine(pm, g).without_ranks({1, 3})
    assert pe.w == je.w == 2
    np.testing.assert_array_equal(pe.f_values(padded).numpy(), np.asarray(je.f_values(padded)))
    with pytest.raises(supervisor.DeviceError):
        pe.without_ranks({0, 1})


def test_supervisor_reshards_as_jax(problem):
    """A chip loss on the dispatch seam: both supervisors rebuild on the
    survivors, record the same reshard event and answer as before."""
    n, edges, padded, jg, g = problem
    jm, pm = _meshes(4, 1)
    out = []
    for sup_mod, fault_mod, eng in (
        (supervisor, faults, DistributedEngine(pm, g)),
        (jsup, jfaults, jdist.DistributedEngine(jm, jg)),
    ):
        plan = fault_mod.FaultPlan.parse("chip:rank1:1")
        sup = sup_mod.ChunkSupervisor(eng, plan=plan)
        best = tuple(int(x) for x in sup.best(padded))
        events = [{k: v for k, v in e.items() if k != "error"} for e in sup.events]
        out.append((best, events, sup.engine.w))
    assert out[0] == out[1]
    assert out[0][1][0]["action"] == "reshard" and out[0][2] == 3


# ---- the CLI at -gn > 1 --------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    n, e = generators.rmat_edges(8, 8, seed=21)
    io.save_graph_bin(str(d / "rmat.bin"), n, e)
    io.save_query_bin(str(d / "rmat_q.bin"), generators.random_queries(n, 12, max_group=5, seed=2))
    n, e = generators.road_edges(30, 30, seed=3)
    io.save_graph_bin(str(d / "road.bin"), n, e)
    io.save_query_bin(str(d / "road_q.bin"), generators.random_queries(n, 12, max_group=6, seed=3))
    return d


def _run(fn, argv):
    out, err = _io.StringIO(), _io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def _stderr_lines(text):
    """stderr without wall times and the dispatch count (which differ)."""
    return [re.sub(r"\d+\.\d+$", "T", ln) for ln in text.splitlines()
            if not ln.startswith(("persistent XLA cache", "dispatch_count"))]


# (graph, environment, the engine announcement both CLIs print, or None).
MESH_CASES = {
    "default": ("rmat", {}, None),
    "vshard2": ("rmat", {"MSBFS_VSHARD": "2"}, None),
    "auto_vshard": ("rmat", {"MSBFS_HBM_BYTES": "60000"}, "auto-sharding the CSR over"),
    "push_road": ("road", {"MSBFS_BACKEND": "push"}, None),
    "road_auto": ("road", {}, "road-class degree profile"),
    "road_vshard4": ("road", {"MSBFS_VSHARD": "4", "MSBFS_STATS": "2"}, "road-class degree profile"),
    "single_chip_only": ("rmat", {"MSBFS_BACKEND": "mxu"}, "is single-chip only"),
    "csr": ("rmat", {"MSBFS_BACKEND": "csr"}, None),
    "halo_stats": ("rmat", {"MSBFS_VSHARD": "2", "MSBFS_STATS": "2",
                            "MSBFS_HALO_BUDGET": "40", "MSBFS_PUSH_HALO": "300"}, "halo_bytes"),
    "vshard_no_divide": ("rmat", {"MSBFS_VSHARD": "3", "MSBFS_PUSH_HALO": "64",
                                "MSBFS_STATS": "1"}, "does not divide 4 chips"),
    "reshard": ("rmat", {"MSBFS_FAULTS": "chip:rank1:1"}, None),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_cli_matches_jax(cli_files, monkeypatch, case):
    graph, env, line = MESH_CASES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    argv = ["prog", "-g", str(cli_files / f"{graph}.bin"),
            "-q", str(cli_files / f"{graph}_q.bin"), "-gn", "4"]
    try:
        port = _run(lambda a: cli.main(a, device="cpu", mesh_devices=["cpu"] * 4), argv)
        faults.activate(None)
        ref = _run(jcli.main, argv)
    finally:
        faults.activate(None)
        jfaults.activate(None)
    assert port[0] == ref[0] == 0
    assert port[1].splitlines()[:5] == ref[1].splitlines()[:5]
    assert "GPU # : 4 GPU" in port[1]
    assert _stderr_lines(port[2]) == _stderr_lines(ref[2])
    if line is not None:
        assert line in port[2]


def test_mesh_cli_reshard_flight_record_matches_jax(cli_files, monkeypatch):
    """A chip loss at -gn 4 leaves the same ``reshard`` record in both
    packages' flight rings: the failed rank and three survivor shards."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
        telemetry as jtelemetry,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        telemetry,
    )

    monkeypatch.setenv("MSBFS_FAULTS", "chip:rank2:1")
    argv = ["prog", "-g", str(cli_files / "rmat.bin"), "-q", str(cli_files / "rmat_q.bin"),
            "-gn", "4"]
    rings = []
    for run, tel in ((lambda a: cli.main(a, device="cpu", mesh_devices=["cpu"] * 4), telemetry),
                     (jcli.main, jtelemetry)):
        tel.flight_recorder().clear()
        try:
            rc, _, _ = _run(run, argv)
        finally:
            faults.activate(None)
            jfaults.activate(None)
        assert rc == 0
        rings.append([{k: e[k] for k in ("kind", "method", "failed_ranks", "survivor_shards")}
                      for e in tel.flight_recorder().snapshot() if e["kind"] == "reshard"])
    assert rings[0] == rings[1] != []
    assert rings[0][0]["failed_ranks"] == [2] and rings[0][0]["survivor_shards"] == 3


def test_gn_clamps_to_one_mesh_device_as_jax(cli_files):
    """``-gn 4`` over a one-entry device list runs the single-device route
    and reports the -gn given, as the JAX CLI does on one device."""
    argv = ["prog", "-g", str(cli_files / "rmat.bin"), "-q", str(cli_files / "rmat_q.bin"),
            "-gn", "4"]
    port = _run(lambda a: cli.main(a, device="cpu", mesh_devices=["cpu"]), argv)
    ref = _run(jcli.main, argv)
    jfaults.activate(None)
    assert port[0] == ref[0] == 0
    assert port[1].splitlines()[:5] == ref[1].splitlines()[:5]
    assert port[1].splitlines()[4] == "GPU # : 4 GPU"
