"""``MSBFS_CHECKPOINT`` in the port (utils/checkpoint.py and the CLI's
branch) against the JAX package: the journal's bytes, resuming across
packages both ways, a foreign journal's exit 1, and a process that
crashes on its third dispatch (exit 137) whose rerun finishes from the
journal with the uninterrupted report."""

import os
import subprocess
import sys

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models.bell import (
    BellGraph as JBellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops.bitbell import (
    BitBellEngine as JBitBellEngine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    checkpoint as jckpt,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.bell import (
    BellGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops.bitbell import (
    BitBellEngine,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    checkpoint,
    faults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 12


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    """Neither CLI leaves its fault plan installed for the next test."""
    yield
    faults.activate(None)
    jfaults.activate(None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    n, edges = generators.rmat_edges(8, edge_factor=8, seed=31)
    queries = generators.random_queries(n, K, max_group=4, seed=32)
    gpath, qpath = str(tmp / "g.bin"), str(tmp / "q.bin")
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, queries)
    padded = tio.pad_queries(queries)
    return dict(argv=["prog", "-g", gpath, "-q", qpath, "-gn", "1"], n=n, edges=edges,
                padded=padded)


def _cli(main, argv, capsys, **kw):
    rc = main(argv, **kw)
    out = capsys.readouterr()
    return rc, out.out.splitlines()[:5], out.err


@pytest.mark.parametrize("stats", ["", "1"])
def test_journal_bytes_equal_jax(files, tmp_path, capsys, monkeypatch, stats):
    """The same run writes the same journal, byte for byte (2-column
    rows, or 4-column with MSBFS_STATS), and the same report."""
    monkeypatch.setenv("MSBFS_CHECKPOINT_CHUNK", "4")
    if stats:
        monkeypatch.setenv("MSBFS_STATS", stats)
    monkeypatch.setenv("MSBFS_CHECKPOINT", str(tmp_path / "port.ckpt"))
    rc, out, err = _cli(cli.main, files["argv"], capsys, device="cpu")
    monkeypatch.setenv("MSBFS_CHECKPOINT", str(tmp_path / "jax.ckpt"))
    jrc, jout, jerr = _cli(jcli.main, files["argv"], capsys)
    assert rc == jrc == 0 and out == jout
    mine = (tmp_path / "port.ckpt").read_bytes()
    assert mine == (tmp_path / "jax.ckpt").read_bytes()
    rows = mine.decode().splitlines()
    assert rows[0].startswith("msbfs-ckpt-v1,") and len(rows) == K + 1
    assert {len(r.split(",")) for r in rows[1:]} == {4 if stats else 2}
    if stats:
        table = err[err.index("query  levels"):]
        assert table == jerr[jerr.index("query  levels"):]


@pytest.mark.parametrize("backend", ["vmap", "packed", "dense", "push", "ppush"])
def test_journal_bytes_equal_jax_on_single_device_routes(tmp_path, capsys, monkeypatch,
                                                          backend):
    """MSBFS_CHECKPOINT on the single-device routes: the same journal,
    byte for byte, and the same report as the JAX CLI."""
    n, edges = generators.road_edges(20, 20, seed=33)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, generators.random_queries(n, 9, max_group=4, seed=34))
    argv = ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]
    monkeypatch.setenv("MSBFS_BACKEND", backend)
    monkeypatch.setenv("MSBFS_CHECKPOINT_CHUNK", "4")
    monkeypatch.setenv("MSBFS_STATS", "1")
    monkeypatch.setenv("MSBFS_CHECKPOINT", str(tmp_path / "port.ckpt"))
    rc, out, _ = _cli(cli.main, argv, capsys, device="cpu")
    monkeypatch.setenv("MSBFS_CHECKPOINT", str(tmp_path / "jax.ckpt"))
    jrc, jout, _ = _cli(jcli.main, argv, capsys)
    assert rc == jrc == 0 and out == jout
    assert (tmp_path / "port.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()


def _partial(path, rows):
    """Keep the journal's header and its first ``rows`` rows."""
    lines = open(path).read().splitlines(keepends=True)
    with open(path, "w") as fh:
        fh.writelines(lines[: rows + 1])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_resume_across_packages(files, tmp_path, writer):
    """A journal one package wrote part of resumes in the other: only the
    missing chunks run, and F and the finished journal equal a full
    run's."""
    n, edges, padded = files["n"], files["edges"], files["padded"]
    g, jg = CSRGraph.from_edges(n, edges), JCSRGraph.from_edges(n, edges)
    e = g.num_directed_edges
    mine = lambda p: checkpoint.CheckpointedRunner(  # noqa: E731
        BitBellEngine(BellGraph.from_host(g, "cpu"), level_chunk=8), p, chunk=3)
    theirs = lambda p: jckpt.CheckpointedRunner(  # noqa: E731
        JBitBellEngine(JBellGraph.from_host(jg), level_chunk=8), p, chunk=3)
    full = str(tmp_path / "full.ckpt")
    want, computed = theirs(full).run(n, e, padded)
    assert computed == K
    path = str(tmp_path / "resume.ckpt")
    first, second = (mine, theirs) if writer == "port" else (theirs, mine)
    first(path).run(n, e, padded)
    _partial(path, 6)  # two whole chunks of three
    got, computed = second(path).run(n, e, padded)
    assert computed == K - 6
    np.testing.assert_array_equal(got, want)
    assert open(path, "rb").read() == open(full, "rb").read()
    assert second(path).best(n, e, padded) == theirs(full).best(n, e, padded)


def test_foreign_journal_exits_1(files, tmp_path, capsys, monkeypatch):
    """A journal of another workload, a file that is no journal, and a
    header without its fingerprint each stop both CLIs with exit 1 and
    the same "Checkpoint error" line."""
    for body in ("msbfs-ckpt-v1,0123456789abcdef\n0,5\n", "not a journal\n", "msbfs-ckpt-v1\n"):
        path = tmp_path / "foreign.ckpt"
        path.write_text(body)
        monkeypatch.setenv("MSBFS_CHECKPOINT", str(path))
        rc, out, err = _cli(cli.main, files["argv"], capsys, device="cpu")
        jrc, jout, jerr = _cli(jcli.main, files["argv"], capsys)
        assert rc == jrc == 1 and out == jout == []
        line = [ln for ln in err.splitlines() if ln.startswith("Checkpoint error")]
        assert line and line == [ln for ln in jerr.splitlines() if ln.startswith("Checkpoint error")]
        assert path.read_text() == body  # left as it was


def _port_cli(argv, env):
    code = (
        "import sys\n"
        "from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli\n"
        f"sys.exit(cli.main({argv!r}, device='cpu'))\n"
    )
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO_ROOT, **env},
    )


def test_crash_then_resume(files, tmp_path, capsys, monkeypatch):
    """crash:dispatch:3 kills the process (exit 137) on its second chunk
    (the first dispatch warms the chunk shape), after the first chunk was
    journaled; the rerun computes the rest and reports what an
    uninterrupted run reports."""
    path = str(tmp_path / "crash.ckpt")
    env = {"MSBFS_CHECKPOINT": path, "MSBFS_CHECKPOINT_CHUNK": "4"}
    proc = _port_cli(files["argv"], {**env, "MSBFS_FAULTS": "crash:dispatch:3"})
    assert proc.returncode == 137, proc.stderr
    assert proc.stdout == ""
    rows = open(path).read().splitlines()
    assert len(rows) == 1 + 4  # the header and the first chunk
    rerun = _port_cli(files["argv"], env)
    assert rerun.returncode == 0, rerun.stderr
    monkeypatch.setenv("MSBFS_CHECKPOINT", str(tmp_path / "clean.ckpt"))
    monkeypatch.setenv("MSBFS_CHECKPOINT_CHUNK", "4")
    jrc, jout, _ = _cli(jcli.main, files["argv"], capsys)
    assert jrc == 0 and rerun.stdout.splitlines()[:5] == jout
    assert open(path, "rb").read() == open(tmp_path / "clean.ckpt", "rb").read()
