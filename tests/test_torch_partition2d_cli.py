"""The port's CLI with ``MSBFS_MESH=RxC`` at ``-gn 4`` (``cli.main(...,
mesh_devices=["cpu"] * 4)``) against the JAX CLI at ``-gn 4`` on its
8-device virtual CPU mesh: the exit code, report lines 1-5 and stderr
(the ``mesh route:`` line, the chunk announcement, the per-query and
per-level tables, each error line) must be equal, for every lattice axis
the route resolves and every refusal it makes."""

import contextlib
import io as _io
import re

import jax
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh2d_cli")
    n, e = generators.rmat_edges(8, 8, seed=21)
    io.save_graph_bin(str(d / "rmat.bin"), n, e)
    io.save_query_bin(str(d / "rmat_q.bin"), generators.random_queries(n, 12, max_group=5, seed=2))
    n, e = generators.road_edges(30, 30, seed=3)
    io.save_graph_bin(str(d / "road.bin"), n, e)
    io.save_query_bin(str(d / "road_q.bin"), generators.random_queries(n, 3, max_group=6, seed=3))
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


# (graph, environment, exit code, a fragment of the port's stderr).
CASES = {
    "2x2": ("rmat", {"MSBFS_MESH": "2x2"}, 0, "mesh route: mesh2d (2x2, "),
    "4x1": ("rmat", {"MSBFS_MESH": "4x1"}, 0, "mesh route: mesh2d (4x1, "),
    "1x4_ring": ("rmat", {"MSBFS_MESH": "1x4", "MSBFS_MERGE_TREE": "ring"}, 0, "(1x4, "),
    "mismatch_3x2": ("rmat", {"MSBFS_MESH": "3x2"}, 1,
                     "MSBFS_MESH=3x2 wants 6 chips but -gn selected 4"),
    "malformed": ("rmat", {"MSBFS_MESH": "2by2"}, 1, "expected RxC"),
    "byte": ("road", {"MSBFS_MESH": "2x2", "MSBFS_BACKEND": "lowk"}, 0, "mesh2d+byte"),
    "byte_knob": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_MESH_PLANE": "byte"}, 0, "mesh2d+byte"),
    "mxu": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_BACKEND": "mxu", "MSBFS_MXU_TILE": "32"}, 0,
            "mesh2d+mxu"),
    "streamed": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_MESH_RESIDENCY": "streamed"}, 0,
                 "mesh2d+streamed"),
    "async3": ("road", {"MSBFS_MESH": "2x2", "MSBFS_ASYNC_LEVELS": "3"}, 0, "mesh2d+async3"),
    "stats2": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_STATS": "2"}, 0, "mesh route: mesh2d"),
    "sparse_stats1": ("road", {"MSBFS_MESH": "2x2", "MSBFS_WIRE_SPARSE": "64",
                               "MSBFS_STATS": "1"}, 0, "mesh route: mesh2d"),
    "pipelined": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_MERGE_TREE": "pipelined",
                           "MSBFS_WIRE_CHUNKS": "2"}, 0, "mesh route: mesh2d"),
    "reshard": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_FAULTS": "chip:rank1:1"}, 0,
                "mesh route: mesh2d"),
    "byte_mxu": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_MESH_PLANE": "byte",
                          "MSBFS_MESH_KERNEL": "mxu"}, 1, "no engine composes"),
    "bad_tree": ("rmat", {"MSBFS_MESH": "2x2", "MSBFS_MERGE_TREE": "bogus"}, 1, "merge tree"),
    "stencil_backend": ("road", {"MSBFS_MESH": "2x2", "MSBFS_BACKEND": "stencil"}, 1,
                        "no engine provides"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh2d_cli_matches_jax(cli_files, monkeypatch, case):
    graph, env, rc, frag = CASES[case]
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
    assert port[0] == ref[0] == rc
    assert port[1].splitlines()[:5] == ref[1].splitlines()[:5]
    assert _stderr_lines(port[2]) == _stderr_lines(ref[2])
    assert frag in port[2]
    if rc == 0:
        assert "GPU # : 4 GPU" in port[1]


def test_mesh_spec_ignored_on_one_device(cli_files, monkeypatch):
    """``MSBFS_MESH`` at ``-gn 1`` runs the single-device route in both
    CLIs (no mesh route line)."""
    monkeypatch.setenv("MSBFS_MESH", "2x2")
    argv = ["prog", "-g", str(cli_files / "rmat.bin"), "-q", str(cli_files / "rmat_q.bin"),
            "-gn", "1"]
    port = _run(lambda a: cli.main(a, device="cpu"), argv)
    ref = _run(jcli.main, argv)
    jfaults.activate(None)
    assert port[0] == ref[0] == 0
    assert port[1].splitlines()[:5] == ref[1].splitlines()[:5]
    assert "mesh route" not in port[2] and "mesh route" not in ref[2]
