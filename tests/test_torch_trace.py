"""The port's ``MSBFS_PROFILE_DIR``: ``utils.trace.profiler_trace`` (a no-op
without a directory, the knob's directory or the caller's, a typed error
when no trace can be taken) and the CLI's computation span under it on
the CPU, whose report keeps the JAX CLI's form and answer."""

import json
import re

import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime.supervisor import (
    InputError,
    MsbfsError,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils.trace import (
    profiler_trace,
)

REPORT = [
    r"Graph: .+",
    r"Query: .+",
    r"Query number \(k\) with minimum F value: \d+",
    r"Minimum F value: \d+",
    r"GPU # : \d+ GPU",
    r"Preprocessing time: \d+\.\d{9} s",
    r"Computation time: \d+\.\d{9} s",
]


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    yield
    faults.activate(None)
    jfaults.activate(None)


def _traces(where):
    return sorted(where.glob("msbfs.*.pt.trace.json"))


def test_no_directory_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.delenv("MSBFS_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with profiler_trace() as path:
        assert path is None
    with profiler_trace("", device="cuda") as path:  # no CUPTI needed either
        assert path is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("source", ["knob", "argument"])
def test_trace_written_into_the_directory(tmp_path, monkeypatch, source):
    import torch

    want = tmp_path / "prof" / "nested"
    monkeypatch.setenv("MSBFS_PROFILE_DIR", str(want if source == "knob" else tmp_path / "x"))
    with profiler_trace(str(want) if source == "argument" else None, device="cpu") as path:
        assert path is not None and path.startswith(str(want))
        torch.arange(1000).sum()
    (written,) = _traces(want)
    assert str(written) == path
    trace = json.loads(written.read_text())
    assert trace["traceEvents"]
    assert trace["msbfs_launches"] == {}  # no kernel on the CPU
    assert not (tmp_path / "x").exists()


def test_unusable_directory_is_an_input_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(InputError, match="MSBFS_PROFILE_DIR"):
        with profiler_trace(str(blocker / "prof"), device="cpu"):
            pass


def test_card_trace_needs_cupti(tmp_path):
    """A CUDA trace where torch cannot trace the card fails before the
    block runs (this CPU build has no CUDA activity)."""
    from torch.profiler import ProfilerActivity, supported_activities

    if ProfilerActivity.CUDA in supported_activities():
        pytest.skip("this torch traces CUDA")
    ran = []
    with pytest.raises(MsbfsError, match="no CUPTI"):
        with profiler_trace(str(tmp_path), device="cuda"):
            ran.append(1)
    assert not ran and not _traces(tmp_path)


def _fixture(tmp_path):
    n, edges = generators.road_edges(20, 20, seed=6)
    g, q = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(g, n, edges)
    io.save_query_bin(q, generators.random_queries(n, 9, max_group=5, seed=7))
    return ["prog", "-g", g, "-q", q, "-gn", "1"]


@pytest.mark.parametrize("backend", ["auto", "bitbell"])
def test_cli_traces_the_computation_span(tmp_path, monkeypatch, capsys, backend):
    argv = _fixture(tmp_path)
    monkeypatch.setenv("MSBFS_BACKEND", backend)
    assert jcli.main(argv) == 0
    jax_lines = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("MSBFS_PROFILE_DIR", str(tmp_path / "prof"))
    assert cli.main(argv, device="cpu") == 0
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 7
    for line, form in zip(lines, REPORT):
        assert re.fullmatch(form, line), line
    assert lines[:5] == jax_lines[:5]
    (trace,) = _traces(tmp_path / "prof")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)


def test_cli_unusable_directory_exits_1(tmp_path, monkeypatch, capsys):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setenv("MSBFS_PROFILE_DIR", str(blocker))
    assert cli.main(_fixture(tmp_path), device="cpu") == 1
    out = capsys.readouterr()
    assert out.out == ""
    last = out.err.splitlines()[-1]
    assert last.startswith("msbfs: InputError: MSBFS_PROFILE_DIR=") and last.endswith("(exit 1)")
