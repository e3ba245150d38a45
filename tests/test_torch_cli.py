"""The port's CLI against the JAX package's ``cli.main`` on the same
fixtures: report lines 1-5 and exit codes, the routing of the default
(bitbell), low-K, byte-plane BELL, ELL, host-streamed and over-memory
branches, the sub-batch split, fault plans (the capacity ladder, retries,
the watchdog, exhausted budgets, the loader seams, a malformed plan), the
weighted route (its flavors, its audit and plane seam) and the ``verify``
subcommand, the routes that are not ported yet, and the port's import
isolation."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import cli as jcli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    faults as jfaults,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    packed as jpacked,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
    stencil as js,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    CSRGraph as JCSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import cli
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
    CSRGraph,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.ops import (
    packed,
    stencil,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    faults,
    io,
)

PORT = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch"
JAX_PKG = "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_fault_plan_left():
    """Neither CLI leaves its fault plan installed for the next test."""
    yield
    faults.activate(None)
    jfaults.activate(None)


def _fixture(tmp_path, k=12, rows=30, cols=30, seed=3, queries=None):
    n, edges = generators.road_edges(rows, cols, seed=seed)
    gpath, qpath = str(tmp_path / "g.bin"), str(tmp_path / "q.bin")
    io.save_graph_bin(gpath, n, edges)
    if queries is None:
        queries = generators.random_queries(n, k, max_group=6, seed=seed)
    io.save_query_bin(qpath, queries)
    return ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]


def _run_both(argv, capsys):
    rc_port = cli.main(argv, device="cpu")
    port = capsys.readouterr()
    rc_jax = jcli.main(argv)
    jax_out = capsys.readouterr()
    return (rc_port, port), (rc_jax, jax_out)


@pytest.mark.parametrize(
    "case",
    [
        "default", "ties_and_empty", "one_query", "no_queries", "chunk_env",
        "subbatch_env",
    ],
)
def test_report_matches_jax(tmp_path, capsys, monkeypatch, case):
    kwargs = {}
    if case == "ties_and_empty":
        q = generators.random_queries(900, 6, max_group=4, seed=7)
        q[1] = np.zeros(0, np.int32)  # F = 0 empty group wins the tie
        q[4] = q[1]
        kwargs["queries"] = q
    elif case == "one_query":
        kwargs["k"] = 1
    elif case == "no_queries":
        kwargs["queries"] = []  # K = 0: the reference reports 0 and -1
    elif case == "chunk_env":
        monkeypatch.setenv("MSBFS_LEVEL_CHUNK", "3")
    elif case == "subbatch_env":
        monkeypatch.setenv("MSBFS_SUBBATCH_K", "16")
        kwargs["k"] = 40
    argv = _fixture(tmp_path, **kwargs)
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == 0
    lines = port.out.splitlines()
    assert len(lines) == 7
    assert lines[:5] == jax_out.out.splitlines()[:5]
    if case == "no_queries":
        assert lines[2:4] == [
            "Query number (k) with minimum F value: 0", "Minimum F value: -1",
        ]
    assert lines[5].startswith("Preprocessing time: ") and lines[5].endswith(" s")
    assert "banded adjacency detected: stencil engine" in port.err
    if case == "subbatch_env":
        assert "splitting 40 queries into 16-wide sub-batches" in port.err


def test_subbatch_k300_matches_jax():
    n, edges = generators.road_edges(20, 20, seed=11)
    queries = io.pad_queries(generators.random_queries(n, 300, max_group=3, seed=12))
    teng = packed.SubBatchEngine(
        stencil.StencilEngine(
            stencil.StencilGraph.from_host(CSRGraph.from_edges(n, edges), "cpu"),
            level_chunk=8,
        )
    )
    jeng = jpacked.SubBatchEngine(
        js.StencilEngine(js.StencilGraph.from_host(JCSRGraph.from_edges(n, edges)))
    )
    winner = int(np.argmin(jeng.query_stats(queries)[2]))
    assert winner < 256
    queries[280] = queries[winner]  # a tie across sub-batches: the first wins
    want = jeng.query_stats(queries)
    for x, y in zip(teng.query_stats(queries), want):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(teng.f_values(queries).numpy(), want[2])
    assert teng.best(queries) == (int(want[2][winner]), winner)
    teng.compile(queries.shape)


@pytest.mark.parametrize(
    "argv", [["prog"], ["prog", "-g", "x.bin"], ["prog", "-g", "a", "-gn", "1"]]
)
def test_usage_exit_matches_jax(argv, capsys):
    assert cli.main(argv, device="cpu") == jcli.main(argv) == -1
    capsys.readouterr()


@pytest.mark.parametrize("missing", ["graph", "query"])
def test_missing_file_matches_jax(tmp_path, capsys, missing):
    argv = _fixture(tmp_path)
    idx = 2 if missing == "graph" else 4
    argv[idx] = str(tmp_path / "absent.bin")
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == 1
    line = f"Could not open {missing} file {argv[idx]}"
    # JAX's CLI announces its compile-cache setting on stderr once per
    # process, before anything else, whichever test reaches it first.
    jax_err = [
        ln for ln in jax_out.err.splitlines()
        if not ln.startswith("persistent XLA cache")
    ]
    assert port.err.splitlines()[0] == jax_err[0] == line
    assert port.out == jax_out.out == ""


@pytest.mark.parametrize(
    "env,subcommand",
    [
        ({"MSBFS_COORDINATOR": "localhost:12345", "MSBFS_NUM_PROCESSES": "2"}, None),
        ({"MSBFS_PROFILE_DIR": "profile"}, None),
        ({"MSBFS_MESH": "2x2"}, None),
        ({"MSBFS_CACHE_DIR": "xla-cache"}, None),
        ({}, "fleet"),
        ({}, "analyze"),
    ],
)
def test_unported_routes_fail_loudly(tmp_path, capsys, monkeypatch, env, subcommand):
    if "MSBFS_PROFILE_DIR" in env:
        # Ported since: both CLIs trace the computation span into the
        # directory (the port a torch.profiler Chrome trace) and report as
        # without it.
        trace_dir = tmp_path / env["MSBFS_PROFILE_DIR"]
        monkeypatch.setenv("MSBFS_PROFILE_DIR", str(trace_dir))
        (rc_port, port), (rc_jax, jax_out) = _run_both(_fixture(tmp_path), capsys)
        assert rc_port == rc_jax == 0
        assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
        assert len(list(trace_dir.glob("msbfs.*.pt.trace.json"))) == 1
        return
    if "MSBFS_MESH" in env:
        # Ported since: at -gn 4 both CLIs tile the graph over a 2x2 mesh
        # (the port's over a logical mesh of four CPU entries), name the
        # same route and report alike.
        monkeypatch.setenv("MSBFS_MESH", env["MSBFS_MESH"])
        argv = _fixture(tmp_path)
        argv[-1] = "4"
        rc_port = cli.main(argv, device="cpu", mesh_devices=["cpu"] * 4)
        port = capsys.readouterr()
        rc_jax = jcli.main(argv)
        jax_out = capsys.readouterr()
        assert rc_port == rc_jax == 0
        assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
        route = [ln for ln in port.err.splitlines() if ln.startswith("mesh route:")]
        assert route == [ln for ln in jax_out.err.splitlines() if ln.startswith("mesh route:")]
        assert route and route[0].startswith("mesh route: mesh2d (2x2, ")
        return
    if subcommand == "analyze":
        # Ported since: both CLIs dispatch ``analyze`` to their passes,
        # which refuse an unknown argument alike.
        argv = ["prog", "analyze", "--frobnicate"]
        (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
        assert rc_port == rc_jax == -1
        assert port.out == jax_out.out == ""
        assert port.err == jax_out.err == "unknown argument '--frobnicate'\n"
        return
    if subcommand == "fleet":
        # Ported since: ``fleet --help`` exits 0 in both CLIs and lists the
        # JAX package's options, and the port's ``--device`` besides.
        helps = []
        for run in (lambda a: cli.main(a, device="cpu"), jcli.main):
            with pytest.raises(SystemExit) as exit_:
                run(["prog", "fleet", "--help"])
            assert exit_.value.code == 0
            helps.append(capsys.readouterr().out)
        mine, theirs = (set(re.findall(r"--[a-z][a-z-]*", h)) for h in helps)
        assert mine == theirs | {"--device"} and "--shard-max-bytes" in theirs
        return
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    argv = _fixture(tmp_path)
    if subcommand:
        argv = ["prog", subcommand] + argv[1:]
    assert cli.main(argv, device="cpu") == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert len(out.err.splitlines()) == 1
    assert "not yet ported" in out.err


# The serving subcommands' argv after the subcommand, for cases that need
# no live daemon; "{dead}" is a unix socket path nothing listens on.
SERVING = {
    "query_dead_socket": ["query", "--connect", "unix:{dead}", "--ping"],
    "query_dead_socket_queries": ["query", "--connect", "unix:{dead}", "-q", "{q}"],
    "health_dead_socket": ["health", "--connect", "unix:{dead}"],
    "trace_dead_socket": ["trace", "--connect", "unix:{dead}", "--list"],
    "serve_bad_listen": ["serve", "--listen", "nohost"],
}


@pytest.mark.parametrize("case", sorted(SERVING))
def test_serving_subcommands_match_jax(tmp_path, capsys, monkeypatch, case):
    """``serve``, ``query``, ``health`` and ``trace`` dispatch as the JAX
    CLI's do: the same exit code, stdout and stderr where no daemon
    answers or the listen address is malformed."""
    monkeypatch.delenv("MSBFS_FAULTS", raising=False)
    argv = _fixture(tmp_path)
    fill = {"dead": str(tmp_path / "nobody.sock"), "q": argv[4]}
    sub = ["prog"] + [a.format(**fill) for a in SERVING[case]]
    (rc_port, port), (rc_jax, jax_out) = _run_both(sub, capsys)
    assert rc_port == rc_jax
    assert rc_port == (1 if case.startswith("serve") else 5)
    assert port.out == jax_out.out
    assert _stderr(port.err) == _stderr(jax_out.err)
    assert not os.path.exists(fill["dead"])


@pytest.mark.parametrize("route", ["batch", "serve"])
def test_cache_dir_is_refused(tmp_path, capsys, monkeypatch, route):
    """``MSBFS_CACHE_DIR`` names the JAX package's persistent XLA compile
    cache; the port builds its kernels into the package's build/ and
    refuses the knob with exit 1, on the batch CLI and on ``serve`` (before
    any graph loads), and an empty value is unset."""
    argv = _fixture(tmp_path)
    if route == "serve":
        argv = ["prog", "serve", "--listen", f"unix:{tmp_path}/s.sock", "-g", argv[2]]
    monkeypatch.setenv("MSBFS_CACHE_DIR", str(tmp_path / "cache"))
    assert cli.main(argv, device="cpu") == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "MSBFS_CACHE_DIR" in out.err and "not yet ported" in out.err
    assert not os.path.exists(tmp_path / "cache")
    assert not os.path.exists(tmp_path / "s.sock")
    if route == "batch":
        monkeypatch.setenv("MSBFS_CACHE_DIR", "")
        assert cli.main(argv, device="cpu") == 0
        assert capsys.readouterr().out.startswith("Graph: ")


def test_serve_needs_a_card(tmp_path):
    """Without ``device``, ``serve`` runs on the card, and raises where
    there is none, before it binds anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: serve would start and wait")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["prog", "serve", "--listen", f"unix:{tmp_path}/s.sock"])
    assert not os.path.exists(tmp_path / "s.sock")


def _stderr(err: str):
    """The stderr lines both CLIs must share (JAX's announces its compile
    cache once per process)."""
    return [ln for ln in err.splitlines() if not ln.startswith("persistent XLA cache")]


# The single-device engines over the flat CSR and the padded table:
# (fixture, environment, exit code); "road" is the 30x30 road grid, "rmat"
# RMAT-8 (its hubs exceed the push routes' width cap), "oob" the road grid
# with out-of-range and repeated sources, "none" no queries.
SINGLE_DEVICE = {
    "vmap": ("road", {"MSBFS_BACKEND": "vmap"}, 0),
    "vmap_rmat_chunked": ("rmat", {"MSBFS_BACKEND": "vmap", "MSBFS_LEVEL_CHUNK": "2"}, 0),
    "packed": ("road", {"MSBFS_BACKEND": "packed"}, 0),
    "packed_rmat": ("rmat", {"MSBFS_BACKEND": "packed"}, 0),
    "packed_edge_chunks": ("rmat", {"MSBFS_BACKEND": "packed", "MSBFS_EDGE_CHUNKS": "3"}, 0),
    "packed_malformed_chunks": ("road", {"MSBFS_BACKEND": "packed", "MSBFS_EDGE_CHUNKS": "x"}, 0),
    "dense": ("road", {"MSBFS_BACKEND": "dense"}, 0),
    "dense_rmat": ("rmat", {"MSBFS_BACKEND": "dense"}, 0),
    "push": ("road", {"MSBFS_BACKEND": "push"}, 0),
    "push_oob": ("oob", {"MSBFS_BACKEND": "push"}, 0),
    "push_malformed_chunk": ("road", {"MSBFS_BACKEND": "push", "MSBFS_PUSH_CHUNK": "abc"}, 0),
    "push_chunk_3": ("road", {"MSBFS_BACKEND": "push", "MSBFS_PUSH_CHUNK": "3"}, 0),
    "push_width_cap": ("rmat", {"MSBFS_BACKEND": "push"}, 1),
    "push_no_queries": ("none", {"MSBFS_BACKEND": "push"}, 0),
    "push_subbatch": ("road", {"MSBFS_BACKEND": "push", "MSBFS_SUBBATCH_K": "5"}, 0),
    "ppush": ("road", {"MSBFS_BACKEND": "ppush"}, 0),
    "ppush_oob": ("oob", {"MSBFS_BACKEND": "ppush"}, 0),
    "ppush_width_cap": ("rmat", {"MSBFS_BACKEND": "ppush"}, 1),
    "ppush_no_queries": ("none", {"MSBFS_BACKEND": "ppush"}, 0),
    "ppush_subbatch": ("road", {"MSBFS_BACKEND": "ppush", "MSBFS_SUBBATCH_K": "5"}, 0),
    "vmap_no_queries": ("none", {"MSBFS_BACKEND": "vmap"}, 0),
    "packed_subbatch": ("road", {"MSBFS_BACKEND": "packed", "MSBFS_SUBBATCH_K": "4"}, 0),
}


@pytest.mark.parametrize("case", list(SINGLE_DEVICE))
def test_single_device_routes_match_jax(tmp_path, capsys, monkeypatch, case):
    """``MSBFS_BACKEND`` = vmap, packed, dense, push and ppush: the same
    exit code, report lines 1-5 and stderr as the JAX CLI (the width cap's
    message with exit 1, the sub-batch line, the capacity protocol's)."""
    fixture, env, code = SINGLE_DEVICE[case]
    if fixture == "rmat":
        argv = _rmat_fixture(tmp_path, k=12)
    elif fixture == "oob":
        argv = _fixture(tmp_path, queries=[[3, 899, 900, 5000], [-4], [7, 7, 8], []])
    else:
        argv = _fixture(tmp_path, **({"queries": []} if fixture == "none" else {}))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == code
    assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
    assert len(port.out.splitlines()) == (7 if code == 0 else 0)
    assert _stderr(port.err) == _stderr(jax_out.err)
    if code:
        assert "exceeds width cap 64" in port.err
    assert "not yet ported" not in port.err


def test_forced_stencil_ignores_stencil_knob(tmp_path, capsys, monkeypatch):
    """MSBFS_STENCIL=0 only turns off the auto route: a forced
    MSBFS_BACKEND=stencil runs, as in the JAX CLI."""
    monkeypatch.setenv("MSBFS_BACKEND", "stencil")
    monkeypatch.setenv("MSBFS_STENCIL", "0")
    (rc_port, port), (rc_jax, jax_out) = _run_both(_fixture(tmp_path), capsys)
    assert rc_port == rc_jax == 0
    assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]


def test_unbanded_graph_fails_loudly(tmp_path, capsys):
    """An unbanded graph with two queries takes the low-K route on auto,
    as in the JAX CLI; forcing the stencil route on it fails loudly."""
    n = 400
    edges = np.random.default_rng(1).integers(0, n, size=(3000, 2))
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, [[1, 2], [3]])
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == 0
    assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
    notice = "low-K fast path: byte-flag engine for 2 queries (MSBFS_LOWK=0 disables)"
    assert notice in port.err.splitlines() and notice in jax_out.err.splitlines()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MSBFS_BACKEND", "stencil")
        assert cli.main(argv, device="cpu") == 1
        assert "not banded" in capsys.readouterr().err


def test_gn_is_reported_as_given(tmp_path, capsys):
    argv = _fixture(tmp_path)
    argv[-1] = "3"  # one device: clamped, reported as given
    assert cli.main(argv, device="cpu") == 0
    assert "GPU # : 3 GPU" in capsys.readouterr().out


def test_no_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_fixture(tmp_path))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {PORT} as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        f" or m == '{JAX_PKG}' or m.startswith('{JAX_PKG}.')]\n"
        "mine = [m for m in sys.modules if m.startswith(pkg.__name__)]\n"
        "print(len(mine), bad, *mine)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    imported = int(proc.stdout.split()[0])
    assert imported >= 15  # every module of the port was imported
    # The tooling's modules are among them: gen_cli and every analysis pass.
    for name in ["gen_cli"] + [f"analysis.{m}" for m in (
        "cli", "core", "errors_pass", "knobs_pass", "locks", "lockwatch", "trace_lint"
    )]:
        assert f"{PORT}.{name}" in proc.stdout.split(), name


def _rmat_fixture(tmp_path, k=40, scale=8, seed=21):
    n, edges = generators.rmat_edges(scale, edge_factor=8, seed=seed)
    gpath, qpath = str(tmp_path / "rmat.bin"), str(tmp_path / "rq.bin")
    io.save_graph_bin(gpath, n, edges)
    io.save_query_bin(qpath, generators.random_queries(n, k, max_group=5, seed=seed + 1))
    return ["prog", "-g", gpath, "-q", qpath, "-gn", "1"]


LOWK = "low-K fast path: byte-flag engine for"

# (fixture, environment, a stderr line both CLIs must print); an "rmat<K>"
# fixture has K query groups, "rmat" 40.
ROUTES = {
    "default_rmat": ("rmat", {}, None),
    "pallas": ("rmat", {"MSBFS_BACKEND": "pallas"}, None),
    "bitbell": ("rmat", {"MSBFS_BACKEND": "bitbell"}, None),
    "unknown_backend": ("rmat", {"MSBFS_BACKEND": "csr", "MSBFS_LEVEL_CHUNK": "2"}, None),
    "stencil_off_road": ("road", {"MSBFS_STENCIL": "0"}, "road-class degree profile"),
    "lowk_off": ("rmat2", {"MSBFS_LOWK": "0"}, None),
    "lowk_auto_k1": ("rmat1", {}, LOWK),
    "lowk_auto_k2": ("rmat2", {}, LOWK),
    "lowk_auto_k3": ("rmat3", {"MSBFS_LEVEL_CHUNK": "1"}, LOWK),
    "lowk_auto_k4": ("rmat4", {}, LOWK),
    "lowk_forced_k2": ("rmat2", {"MSBFS_BACKEND": "lowk"}, LOWK),
    "lowk_forced_k40": ("rmat", {"MSBFS_BACKEND": "lowk"}, LOWK),
    "lowk_forced_subbatch": (
        "rmat", {"MSBFS_BACKEND": "lowk", "MSBFS_SUBBATCH_K": "16"}, "16-wide sub-batches",
    ),
    "lowk_max_k_raised": ("rmat6", {"MSBFS_LOWK_MAX_K": "8"}, LOWK),
    "lowk_road_stencil_off": ("road", {"MSBFS_STENCIL": "0", "MSBFS_LOWK_MAX_K": "12"}, LOWK),
    "bell": ("rmat", {"MSBFS_BACKEND": "bell"}, None),
    "bell_chunked": ("rmat3", {"MSBFS_BACKEND": "bell", "MSBFS_LEVEL_CHUNK": "2"}, None),
    "over_memory": ("rmat", {"MSBFS_HBM_BYTES": "100000"}, "dropping the hybrid CSR"),
    "over_memory_chunk0": (
        "rmat", {"MSBFS_HBM_BYTES": "100000", "MSBFS_LEVEL_CHUNK": "0"},
        "clamping to 8 levels/dispatch",
    ),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_routes_match_jax(tmp_path, capsys, monkeypatch, case):
    """Report lines 1-5 and the exit code of the bitbell and ELL routes,
    and the stderr line of the branch taken, equal the JAX CLI's."""
    fixture, env, line = ROUTES[case]
    if fixture == "road":
        argv = _fixture(tmp_path)
    else:
        argv = _rmat_fixture(tmp_path, k=int(fixture[4:] or 40))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == 0
    lines = port.out.splitlines()
    assert len(lines) == 7 and lines[:5] == jax_out.out.splitlines()[:5]
    assert "banded adjacency" not in port.err
    if line:
        mine = [ln for ln in port.err.splitlines() if line in ln]
        theirs = [ln for ln in jax_out.err.splitlines() if line in ln]
        assert mine and mine == theirs
    lowk_route = case.startswith("lowk_") and case != "lowk_off"
    assert (LOWK in port.err) == (LOWK in jax_out.err) == lowk_route


def test_lowk_route_refused_as_jax_routes_it(tmp_path, capsys, monkeypatch):
    """K <= MSBFS_LOWK_MAX_K on auto takes JAX's low-K route, with its
    notice, and not the bitbell route; over memory, or with the knob
    lowered below K, it does not, in both CLIs."""
    argv = _rmat_fixture(tmp_path, k=3)
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == 0
    assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
    notice = f"{LOWK} 3 queries (MSBFS_LOWK=0 disables)"
    assert notice in port.err.splitlines() and notice in jax_out.err.splitlines()
    for knob, value in (("MSBFS_LOWK_MAX_K", "2"), ("MSBFS_HBM_BYTES", "100000")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(knob, value)
            (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
        assert rc_port == rc_jax == 0
        assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
        assert LOWK not in port.err and LOWK not in jax_out.err


# (environment, exit code): fault plans through both CLIs on the default
# route (the capacity ladder, retries, the watchdog, exhausted budgets, the
# loader seams, a malformed plan), the ELL route's plane seam, and the
# host-streamed route.
FAULT_CASES = {
    "oom_one_rung": ({"MSBFS_FAULTS": "oom:dispatch:1"}, 0),
    "oom_two_rungs": ({"MSBFS_FAULTS": "oom:dispatch:1,oom:dispatch:2"}, 0),
    "oom_three_rungs": (
        {"MSBFS_FAULTS": "oom:dispatch:1,oom:dispatch:2,oom:dispatch:3",
         "MSBFS_LEVEL_CHUNK": "0"}, 0,
    ),
    "oom_exhausted": ({"MSBFS_FAULTS": "oom:dispatch:1,oom:dispatch:2,oom:dispatch:3"}, 3),
    "oom_in_computation": ({"MSBFS_FAULTS": "oom:dispatch:2"}, 0),
    "transient_retried": ({"MSBFS_FAULTS": "transient:dispatch:2"}, 0),
    "transient_exhausted": (
        {"MSBFS_FAULTS": "transient:dispatch:1,transient:dispatch:2,transient:dispatch:3"}, 5,
    ),
    "watchdog": (
        {"MSBFS_FAULTS": "hang:dispatch:1", "MSBFS_FAULT_HANG": "0.5",
         "MSBFS_WATCHDOG": "0.1", "MSBFS_RETRIES": "0"}, 5,
    ),
    "io_load_graph": ({"MSBFS_FAULTS": "io:load_graph:1"}, 1),
    "corrupt_load_query": ({"MSBFS_FAULTS": "corrupt:load_query:1"}, 1),
    "bogus_plan": ({"MSBFS_FAULTS": "bogus"}, 1),
    "ell_plane_bitflip": ({"MSBFS_BACKEND": "pallas", "MSBFS_FAULTS": "bitflip:plane0:1"}, 0),
    "streamed": ({"MSBFS_BACKEND": "streamed"}, 0),
    "streamed_segments": ({"MSBFS_BACKEND": "streamed", "MSBFS_SLOT_BUDGET": "300"}, 0),
}


@pytest.mark.parametrize("case", list(FAULT_CASES))
def test_fault_plans_match_jax(tmp_path, capsys, monkeypatch, case):
    """The same exit code, report lines 1-5 (the times differ) and the
    same one-line failure report on stderr as the JAX CLI."""
    env, code = FAULT_CASES[case]
    argv = _rmat_fixture(tmp_path)
    monkeypatch.setenv("MSBFS_BACKOFF", "0.001")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    (rc_port, port), (rc_jax, jax_out) = _run_both(argv, capsys)
    assert rc_port == rc_jax == code
    assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
    assert len(port.out.splitlines()) == (7 if code == 0 else 0)
    mine = [ln for ln in port.err.splitlines() if ln.startswith(("msbfs:", "Could not"))]
    theirs = [ln for ln in jax_out.err.splitlines() if ln.startswith(("msbfs:", "Could not"))]
    assert mine == theirs
    assert bool(mine) == (code != 0)


def _weighted_fixture(tmp_path, kind="road", costs="uniform"):
    """A weighted 12x12 road (or RMAT-8) and its weightless twin, with 8
    groups; group 4 holds vertex 130, the cell of the 144-vertex, K = 8
    plane that the plane seam's bit flip lands on (zlib.crc32("wplane")),
    so a flipped plane changes that group's F."""
    if kind == "road":
        n, edges = generators.road_edges(12, 12, seed=2)
    else:
        n, edges = generators.rmat_edges(8, edge_factor=8, seed=21)
    w = generators.edge_costs(len(edges), costs, 16, seed=5)
    paths = {name: str(tmp_path / f"{name}.bin") for name in ("w", "u", "q")}
    io.save_graph_bin(paths["w"], n, edges, w)
    io.save_graph_bin(paths["u"], n, edges)
    queries = generators.random_queries(n, 8, max_group=5, seed=6)
    queries[3] = np.array([130], np.int32)
    io.save_query_bin(paths["q"], queries)
    return paths


_WPLANE_ALL = ",".join(f"bitflip:wplane:{i}" for i in range(1, 13))

# (fixture, graph file, environment, exit code) of the weighted route.
WEIGHTED = {
    "auto": ("road", "w", {}, 0),
    "bitbell": ("road", "w", {"MSBFS_WEIGHTED_ENGINE": "bitbell"}, 0),
    "stencil": ("road", "w", {"MSBFS_WEIGHTED_ENGINE": "stencil"}, 0),
    "mesh2d": ("road", "w", {"MSBFS_WEIGHTED_ENGINE": "mesh2d"}, 0),
    "delta_1": ("road", "w", {"MSBFS_DELTA": "1"}, 0),
    "rmat_zipf_stencil": ("rmat_zipf", "w", {"MSBFS_WEIGHTED_ENGINE": "stencil"}, 0),
    "rmat_mesh2d_delta_99": (
        "rmat", "w", {"MSBFS_WEIGHTED_ENGINE": "mesh2d", "MSBFS_DELTA": "99"}, 0,
    ),
    "stats": ("road", "w", {"MSBFS_STATS": "1"}, 0),
    "subbatch": ("road", "w", {"MSBFS_SUBBATCH_K": "3"}, 0),
    "over_other_routes": ("road", "w", {"MSBFS_BACKEND": "mxu", "MSBFS_STENCIL": "0"}, 0),
    "weightless": ("road", "u", {}, 1),
    "unknown_flavor": ("road", "w", {"MSBFS_WEIGHTED_ENGINE": "gpu"}, 1),
    "audit_full": ("road", "w", {"MSBFS_AUDIT": "full"}, 0),
    "audit_sampled": ("road", "w", {"MSBFS_AUDIT": "0.5", "MSBFS_CHECKPOINT_CHUNK": "2"}, 0),
    # The checkpointed runner calls f_values, the audited method: a flip
    # the audit catches once is retried to the right answer; a flip on
    # every call exhausts the audit and exits 9.
    "audit_wplane_transient": (
        "road", "w", {"MSBFS_AUDIT": "full", "MSBFS_FAULTS": "bitflip:wplane:2"}, 0,
    ),
    "audit_wplane_persistent": (
        "road", "w", {"MSBFS_AUDIT": "full", "MSBFS_RETRIES": "0",
                      "MSBFS_FAULTS": _WPLANE_ALL}, 9,
    ),
    # Without the audit a flipped plane is served, as in the JAX CLI.
    "wplane_unaudited": ("road", "w", {"MSBFS_FAULTS": "bitflip:wplane:2"}, 0),
}
_CHECKPOINTED = ("audit_sampled", "audit_wplane_transient", "audit_wplane_persistent",
                 "wplane_unaudited")


def _failure_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith(("msbfs:", "weighted route:"))]


@pytest.mark.parametrize("case", list(WEIGHTED))
def test_weighted_route_matches_jax(tmp_path, capsys, monkeypatch, case):
    """MSBFS_WEIGHTED=1: the same exit code, report lines 1-5, route line
    and failure line (and stats table) as the JAX CLI."""
    fixture, graph, env, code = WEIGHTED[case]
    kind, _, costs = fixture.partition("_")
    paths = _weighted_fixture(tmp_path, kind, costs or "uniform")
    argv = ["prog", "-g", paths[graph], "-q", paths["q"], "-gn", "1"]
    monkeypatch.setenv("MSBFS_WEIGHTED", "1")
    monkeypatch.setenv("MSBFS_BACKOFF", "0.001")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    runs = []
    for name, run in (("port", lambda: cli.main(argv, device="cpu")),
                      ("jax", lambda: jcli.main(argv))):
        if case in _CHECKPOINTED:
            monkeypatch.setenv("MSBFS_CHECKPOINT", str(tmp_path / f"{name}.ckpt"))
        rc = run()
        runs.append((rc, capsys.readouterr()))
    (rc_port, port), (rc_jax, jax_out) = runs
    assert rc_port == rc_jax == code
    assert port.out.splitlines()[:5] == jax_out.out.splitlines()[:5]
    assert len(port.out.splitlines()) == (7 if code == 0 else 0)
    assert _failure_lines(port.err) == _failure_lines(jax_out.err)
    assert any(ln.startswith("weighted route:") for ln in port.err.splitlines()) == (code != 1)
    if case == "stats":
        assert _stderr(port.err) == _stderr(jax_out.err)


# (arguments after the subcommand, environment, exit code) of ``verify``;
# "F" in an argument is the true F vector, "F+1" one nudged, "@F" a file.
VERIFY = {
    "weighted": (["-g", "w", "--weighted"], {}, 0),
    "weighted_by_knob": (["-g", "w"], {"MSBFS_WEIGHTED": "1"}, 0),
    "hop_on_weightless": (["-g", "u"], {}, 0),
    "hop_on_weighted_file": (["-g", "w"], {}, 0),
    "hop_backend_vmap": (["-g", "u"], {"MSBFS_BACKEND": "vmap", "MSBFS_AUDIT": "full"}, 0),
    "hop_backend_lowk": (["-g", "u"], {"MSBFS_BACKEND": "lowk"}, 0),
    "weighted_stencil_audited": (
        ["-g", "w", "--weighted"], {"MSBFS_WEIGHTED_ENGINE": "stencil", "MSBFS_AUDIT": "full"}, 0,
    ),
    "weighted_on_weightless": (["-g", "u", "--weighted"], {}, 1),
    "expect_true": (["-g", "w", "--weighted", "--expect-f", "F"], {}, 0),
    "expect_file": (["-g", "w", "--weighted", "--expect-f", "@F"], {}, 0),
    "expect_wrong": (["-g", "w", "--weighted", "--expect-f", "F+1"], {}, 9),
    "expect_wrong_hop": (["-g", "u", "--expect-f", "F+1"], {}, 9),
    "expect_malformed": (["-g", "w", "--weighted", "--expect-f", "[1,"], {}, 1),
    "expect_missing_file": (["-g", "w", "--weighted", "--expect-f", "@nope.json"], {}, 1),
    "missing_graph": (["-g", "nope"], {}, 1),
}


@pytest.mark.parametrize("case", list(VERIFY))
def test_verify_matches_jax(tmp_path, capsys, monkeypatch, case):
    """``verify``: the same stdout, failure line and exit code as the JAX
    CLI's (0 certified, 9 a wrong claim, 1 a bad input)."""
    import json

    args, env, code = VERIFY[case]
    paths = _weighted_fixture(tmp_path)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    weighted = "--weighted" in args or env.get("MSBFS_WEIGHTED") == "1"
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.ops import (
        certify as jcertify,
    )

    gpath = paths[args[1]] if args[1] in paths else str(tmp_path / args[1])
    g = io.load_graph_bin(gpath) if os.path.exists(gpath) else None
    rows = io.pad_queries(io.load_query_bin(paths["q"]))
    if g is not None and (g.has_weights or not weighted):
        dist = (jcertify.reference_weighted_distances(
            g.row_offsets, g.col_indices, g.edge_weights, rows) if weighted
            else jcertify.reference_distances(g.row_offsets, g.col_indices, rows))
        truth = jcertify.f_from_distances(dist).tolist()
        (tmp_path / "f.json").write_text(json.dumps(truth))
    subs = {"F": lambda: json.dumps(truth),
            "F+1": lambda: json.dumps([truth[0] + 1] + truth[1:]),
            "@F": lambda: "@" + str(tmp_path / "f.json"),
            "@nope.json": lambda: "@" + str(tmp_path / "nope.json")}
    argv = ["prog", "verify", "-g", gpath, "-q", paths["q"]] + [
        subs[a]() if a in subs else a for a in args[2:]
    ]
    rc_port = cli.main(argv, device="cpu")
    port = capsys.readouterr()
    rc_jax = jcli.main(argv)
    jax_out = capsys.readouterr()
    assert rc_port == rc_jax == code
    assert port.out == jax_out.out
    assert _failure_lines(port.err) == _failure_lines(jax_out.err)
    assert port.out.startswith("verify: CERTIFIED") == (code == 0)


@pytest.mark.parametrize("script", ["chip_smoke.py", "chip_compare.py", "chip_probe_csr.py",
                                    "chip_probe_queue.py", "chip_probe_scan.py",
                                    "chip_probe_forest_max.py"])
def test_chip_scripts_import_no_jax(script):
    """The card's scripts name no jax module and nothing of the JAX
    package in any import, at any depth of the file."""
    import ast

    with open(os.path.join(REPO_ROOT, script)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and any(n.startswith(PORT) for n in names)
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", JAX_PKG)]
