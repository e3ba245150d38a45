"""``MSBFS_STATS`` and the flight recorder in the port's CLI against the
JAX CLI: the stderr block (``dispatch_count:``, the per-level trace under
``=2`` and the per-query table) with the level times masked, on the
bitbell, stencil, ELL, vmap, dense and push routes and the notes of the
other cases; and the
``MSBFS_FLIGHT_RECORDER`` file a typed failure leaves, warm-up and
computation span alike."""

import json
import re

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    telemetry as jtelemetry,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    telemetry,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)

_SECONDS = re.compile(r"\d+\.\d{6}$", re.M)


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    """Neither CLI leaves its fault plan installed for the next test."""
    yield
    faults.activate(None)
    jfaults.activate(None)


def _fixture(tmp_path, kind, k):
    if kind == "road":
        n, edges = generators.road_edges(24, 24, seed=9)
    else:
        n, edges = generators.rmat_edges(8, edge_factor=8, seed=13)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, generators.random_queries(n, k, max_group=4, seed=14)
                       if k else [])
    return ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]


def _run_both(argv, capsys, between=lambda: None):
    rc = cli.main(argv, device="cpu")
    port = capsys.readouterr()
    between()
    jrc = jcli.main(argv)
    theirs = capsys.readouterr()
    jerr = "".join(
        ln for ln in theirs.err.splitlines(keepends=True)
        if not ln.startswith("persistent XLA cache")
    )
    return (rc, port.out, port.err), (jrc, theirs.out, jerr)


CASES = {
    "bitbell_1": ("rmat", 40, {"MSBFS_STATS": "1"}, "query  levels"),
    "bitbell_2": ("rmat", 40, {"MSBFS_STATS": "2"}, "level  discovered"),
    "stencil_1": ("road", 12, {"MSBFS_STATS": "1"}, "query  levels"),
    "stencil_2": ("road", 12, {"MSBFS_STATS": "2"}, "level  discovered"),
    # Under =2 the auto route keeps bitbell for K <= 4 (no low-K).
    "lowk_k_stats_2": ("rmat", 3, {"MSBFS_STATS": "2"}, "level  discovered"),
    "lowk_forced_2": ("rmat", 3, {"MSBFS_STATS": "2", "MSBFS_BACKEND": "lowk"},
                      "per-level trace not available on this engine"),
    "bell_2": ("rmat", 40, {"MSBFS_STATS": "2", "MSBFS_BACKEND": "bell"},
               "per-level trace not available on this engine"),
    "streamed_2": ("rmat", 40, {"MSBFS_STATS": "2", "MSBFS_BACKEND": "streamed"},
                   "per-level trace not available on this engine"),
    "ell_1": ("rmat", 40, {"MSBFS_STATS": "1", "MSBFS_BACKEND": "pallas"}, "query  levels"),
    "no_queries": ("rmat", 0, {"MSBFS_STATS": "1"}, "MSBFS_STATS: no queries"),
    "checkpoint_2": ("rmat", 40, {"MSBFS_STATS": "2", "MSBFS_CHECKPOINT": "{tmp}/j.ckpt"},
                     "not available under checkpointing"),
    "vmap_1": ("rmat", 40, {"MSBFS_STATS": "1", "MSBFS_BACKEND": "vmap"}, "query  levels"),
    "packed_2": ("rmat", 40, {"MSBFS_STATS": "2", "MSBFS_BACKEND": "packed"},
                 "per-level trace not available on this engine"),
    "dense_1": ("road", 12, {"MSBFS_STATS": "1", "MSBFS_BACKEND": "dense"}, "query  levels"),
    "push_1": ("road", 12, {"MSBFS_STATS": "1", "MSBFS_BACKEND": "push"}, "query  levels"),
    "push_2": ("road", 12, {"MSBFS_STATS": "2", "MSBFS_BACKEND": "push"}, "level  discovered"),
    "ppush_2": ("road", 12, {"MSBFS_STATS": "2", "MSBFS_BACKEND": "ppush"},
                "level  discovered"),
    "ppush_checkpoint_1": ("road", 12, {"MSBFS_STATS": "1", "MSBFS_BACKEND": "ppush",
                                        "MSBFS_CHECKPOINT": "{tmp}/j.ckpt"}, "query  levels"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_stats_block_matches_jax(tmp_path, capsys, monkeypatch, case):
    """Exit code, report lines 1-5 and the whole stderr equal JAX's once
    the per-level seconds are masked."""
    kind, k, env, marker = CASES[case]
    argv = _fixture(tmp_path, kind, k)
    for key, value in env.items():
        monkeypatch.setenv(key, value.format(tmp=tmp_path))
    journal = tmp_path / "j.ckpt"
    # Each CLI starts from no journal (the second would resume the first's).
    (rc, out, err), (jrc, jout, jerr) = _run_both(
        argv, capsys, between=lambda: journal.unlink(missing_ok=True))
    assert rc == jrc == 0
    assert out.splitlines()[:5] == jout.splitlines()[:5]
    assert _SECONDS.sub("T", err) == _SECONDS.sub("T", jerr)
    assert marker in err and "dispatch_count: " in err
    if marker == "level  discovered":
        rows = err[err.index(marker):err.index("query  levels")].splitlines()[1:]
        assert len(rows) >= 3 and all(_SECONDS.search(r) for r in rows)


@pytest.mark.parametrize(
    "plan,code",
    [
        pytest.param("oom:dispatch:1,oom:dispatch:2,oom:dispatch:3", 3, id="warm-up"),
        pytest.param("transient:dispatch:2,transient:dispatch:3,transient:dispatch:4", 5,
                     id="computation"),
    ],
)
def test_flight_recorder_on_typed_failure(tmp_path, capsys, monkeypatch, plan, code):
    """A typed failure appends the flight ring and its ``flight_dump``
    marker to MSBFS_FLIGHT_RECORDER before the one-line report: the same
    kinds, reason and count as the JAX CLI's."""
    argv = _fixture(tmp_path, "rmat", 40)
    monkeypatch.setenv("MSBFS_FAULTS", plan)
    monkeypatch.setenv("MSBFS_BACKOFF", "0.001")
    monkeypatch.setenv("MSBFS_FLIGHT_RECORDER", str(tmp_path / "port.jsonl"))
    telemetry.flight_recorder().clear()
    rc = cli.main(argv, device="cpu")
    port = capsys.readouterr()
    monkeypatch.setenv("MSBFS_FLIGHT_RECORDER", str(tmp_path / "jax.jsonl"))
    jtelemetry.flight_recorder().clear()
    jrc = jcli.main(argv)
    theirs = capsys.readouterr()
    assert rc == jrc == code
    assert port.out == theirs.out == ""
    assert port.err.splitlines()[-1] == [ln for ln in theirs.err.splitlines() if ln][-1]
    mine = [json.loads(ln) for ln in (tmp_path / "port.jsonl").read_text().splitlines()]
    want = [json.loads(ln) for ln in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in mine] == [e["kind"] for e in want]
    assert mine[-1]["kind"] == "flight_dump"
    assert mine[-1]["reason"] == want[-1]["reason"] == f"exit_{code}"
    assert mine[-1]["events"] == want[-1]["events"]


def test_flight_recorder_ring_and_dump(tmp_path, monkeypatch):
    """The ring keeps the newest events; a dump appends them with the
    marker, does nothing without a path, and reports a failed write."""
    rec = telemetry.FlightRecorder(maxlen=3)
    for i in range(5):
        rec.record("audit_fail", attempt=i)
    assert [e["attempt"] for e in rec.snapshot()] == [2, 3, 4]
    assert rec.dump("exit_9") is None  # no MSBFS_FLIGHT_RECORDER
    path = tmp_path / "f.jsonl"
    monkeypatch.setenv("MSBFS_FLIGHT_RECORDER", str(path))
    assert rec.dump("exit_9") == str(path)
    assert rec.dump("exit_3") == str(path)
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["audit_fail"] * 3 + ["flight_dump"] + \
        ["audit_fail"] * 3 + ["flight_dump"]
    assert lines[3]["reason"] == "exit_9" and lines[3]["events"] == 3
    assert rec.dump("x", path=str(tmp_path / "absent" / "f.jsonl")) is None
    assert np.all([e["ts"] > 0 for e in lines])
