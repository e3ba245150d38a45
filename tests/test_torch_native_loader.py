"""The port's native runtime (runtime/loader.cpp) against its own NumPy
versions and against the JAX package's NumPy layouts, byte for byte.

Fixtures are made from a numpy seed: a G(n, m)-style multigraph with
duplicate records, self-loops, isolated vertices and two hubs wider than
the widest BELL rung (256), so that the forest has two levels, and one
RMAT-16 graph.  The JAX package's own native library is never built here:
its NumPy paths are the reference (its library hidden by a patch).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
    bell as jbell,
    csr as jcsr,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    native_loader as jax_native,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    io as jio,
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
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
    native_loader,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
    timing,
)

from conftest import REPO_ROOT

THREADS = ("1", "3", "8")


def _multigraph(seed=0):
    """n = 3000: records among the first 2400 vertices (the rest
    isolated), repeated records, self-loops, and hubs 7 (600 neighbours)
    and 11 (300, some repeated)."""
    rng = np.random.default_rng(seed)
    n = 3000
    base = rng.integers(0, 2400, size=(9000, 2))
    hub7 = np.stack([np.full(600, 7), rng.choice(2400, 600, replace=False)], axis=1)
    hub11 = np.stack([rng.integers(0, 2400, 300), np.full(300, 11)], axis=1)
    loops = np.array([[5, 5], [5, 5], [7, 7], [2399, 2399]])
    edges = np.concatenate([base, hub7, base[:500], hub11, loops, hub11[:40]])
    return n, edges[rng.permutation(len(edges))].astype(np.int32)


def _rmat16():
    return generators.rmat_edges(16, edge_factor=16, seed=7)


FIXTURES = {"multigraph": _multigraph, "rmat16": _rmat16}


@pytest.fixture
def jax_numpy(monkeypatch):
    """The JAX package's NumPy paths: its native library hidden."""
    monkeypatch.setattr(jax_native, "_get_lib", lambda: None)


def _layout(bg):
    """Every array of a port BellGraph as NumPy."""
    return dict(
        level_cols=[c.numpy() for c in bg.level_cols],
        level_shapes=bg.level_shapes,
        level_sizes=bg.level_sizes,
        final_slot=bg.final_slot.numpy(),
        walk=bg._walk,
        fill=bg.fill,
        sparse=[s.numpy() for s in bg.sparse],
    )


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_layout(a, b):
    for key in ("level_shapes", "level_sizes", "fill"):
        assert a[key] == b[key], key
    for key in ("level_cols", "sparse"):
        assert len(a[key]) == len(b[key])
        for x, y in zip(a[key], b[key]):
            _same(x, y)
    _same(a["final_slot"], b["final_slot"])
    assert len(a["walk"]) == len(b["walk"])
    for (r1, f1), (r2, f2) in zip(a["walk"], b["walk"]):
        _same(r1, r2)
        _same(f1, f2)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_native_layouts_match_numpy_and_jax(name, jax_numpy):
    """CSR, dedup and BELL layout: the port's native build equals its NumPy
    build and the JAX package's NumPy build, array for array."""
    n, edges = FIXTURES[name]()
    g = CSRGraph.from_edges(n, edges)
    g_np = CSRGraph.from_edges(n, edges, native=False)
    jg = jcsr.CSRGraph.from_edges(n, edges)
    for a, b in ((g, g_np), (g, jg)):
        _same(a.row_offsets, b.row_offsets)
        _same(a.col_indices, b.col_indices)
    for x, y in zip(g.dedup_rows(), g.dedup_rows(native=False)):
        _same(x, y)
    dedup = g.deduped_pairs()
    for other in (g.deduped_pairs(native=False), jg.deduped_pairs()):
        for x, y in zip(dedup, other):
            _same(x, np.asarray(y, dtype=np.int64))
    bg = _layout(BellGraph.from_host(g, "cpu"))
    _same_layout(bg, _layout(BellGraph.from_host(g, "cpu", native=False)))
    assert len(bg["level_sizes"]) >= 2  # a hub wider than 256 slots
    jb = jbell.BellGraph.from_host(jg, device=False)
    assert bg["level_shapes"] == jb.level_shapes
    assert bg["level_sizes"] == jb.level_sizes
    assert bg["fill"] == jb.fill
    for x, y in zip(bg["level_cols"], jb.level_cols):
        _same(x, y)
    _same(bg["final_slot"], jb.final_slot)


@pytest.mark.parametrize("threads", THREADS)
def test_native_passes_are_thread_invariant(threads, monkeypatch, tmp_path, jax_numpy):
    """At 1, 3 and 8 threads every native pass gives the NumPy bytes: the
    file decode, the CSR build, the dedup, the BELL levels."""
    monkeypatch.setenv("MSBFS_NATIVE_THREADS", threads)
    n, edges = _multigraph(seed=3)
    path = tmp_path / "g.bin"
    tio.save_graph_bin(path, n, edges)
    loaded = tio.load_graph_bin(path)
    want = jio.load_graph_bin(path, native=False)
    for a, b in ((loaded, want), (CSRGraph.from_edges(n, edges), want)):
        _same(a.row_offsets, b.row_offsets)
        _same(a.col_indices, b.col_indices)
    _same_layout(
        _layout(BellGraph.from_host(loaded, "cpu")),
        _layout(BellGraph.from_host(loaded, "cpu", native=False)),
    )


@pytest.mark.parametrize("threads", ("1", "3"))
def test_dedup_rows_nonzero_first_offset(threads, monkeypatch):
    """Slots before the first row belong to no row; the compaction still
    lands the first block at offset 0."""
    monkeypatch.setenv("MSBFS_NATIVE_THREADS", threads)
    row_offsets = np.array([1, 3, 4], dtype=np.int64)
    col_indices = np.array([99, 1, 1, 0], dtype=np.int32)
    dst, deg = native_loader.dedup_rows(row_offsets, col_indices)
    np.testing.assert_array_equal(deg, [1, 1])
    np.testing.assert_array_equal(dst, [1, 0])


# (call on the port's native_loader or the JAX package's, expected type and
# message: the JAX package's native bindings raise these).
BINDING_ERRORS = {
    "csr_endpoint_out_of_range": (
        lambda nl: nl.csr_from_edges(4, np.array([[0, 1], [2, 4]], np.int32)),
        ValueError, "edge endpoint out of range [0, 4)",
    ),
    "csr_endpoint_beyond_int32": (
        lambda nl: nl.csr_from_edges(4, np.array([[0, 1 << 33]], np.int64)),
        ValueError, "edge endpoint exceeds int32",
    ),
    "dedup_overlapping_rows": (
        lambda nl: nl.dedup_rows(np.array([0, 3, 2], np.int64), np.zeros(3, np.int32)),
        ValueError, "native dedup_rows: corrupt CSR input",
    ),
    "bell_items_out_of_range": (
        lambda nl: nl.bell_level(
            np.array([0, 5], np.int64), np.array([2, 2], np.int64),
            np.arange(4), (1, 2), 9,
        ),
        ValueError, "native bell_fill failed (rc=2)",
    ),
}


@pytest.mark.parametrize("case", sorted(BINDING_ERRORS))
def test_native_binding_errors_match_jax(case):
    call, exc, message = BINDING_ERRORS[case]
    with pytest.raises(exc) as port_err:
        call(native_loader)
    assert str(port_err.value) == message
    if jax_native.available():
        with pytest.raises(exc) as jax_err:
            call(jax_native)
        assert str(jax_err.value) == message


def test_csr_from_edges_endpoint_errors_match_jax(jax_numpy):
    """CSRGraph.from_edges checks its bounds before either build."""
    edges = np.array([[0, 1], [3, -1]], np.int32)
    with pytest.raises(ValueError) as jax_err:
        jcsr.CSRGraph.from_edges(4, edges)
    for native in (True, False):
        with pytest.raises(ValueError) as port_err:
            CSRGraph.from_edges(4, edges, native=native)
        assert str(port_err.value) == str(jax_err.value)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """An empty build directory, and the process's library forgotten
    before and after the test."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "build")
    native_loader.library.cache_clear()
    yield tmp_path / "build"
    native_loader.library.cache_clear()


def test_missing_compiler_raises_no_fallback(fresh_build, monkeypatch, tmp_path):
    """No compiler, no library: the default path raises the build's error
    and never decodes with NumPy instead."""
    n, edges = _multigraph()
    path = tmp_path / "g.bin"
    tio.save_graph_bin(path, n, edges)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(native_loader.NativeBuildError, match="no-such-compiler"):
        tio.load_graph_bin(path)
    with pytest.raises(native_loader.NativeBuildError):
        CSRGraph.from_edges(n, edges)
    assert not fresh_build.exists() or not list(fresh_build.glob("*.so"))
    # The NumPy decoder is reached only when asked for.
    assert tio.load_graph_bin(path, native=False).m == len(edges)


def test_failing_compiler_error_carries_its_output(fresh_build, monkeypatch, tmp_path):
    fake = tmp_path / "fake-c++"
    fake.write_text("#!/bin/sh\necho 'fatal: cannot compile here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    with pytest.raises(native_loader.NativeBuildError) as err:
        native_loader.library()
    assert "exit 3" in str(err.value) and "fatal: cannot compile here" in str(err.value)
    assert not list(fresh_build.glob("*.so")) and not list(fresh_build.glob("*.tmp"))


def test_cli_reports_the_compiler_failure(fresh_build, monkeypatch, tmp_path, capsys):
    n, edges = _multigraph()
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, [[1, 2]])
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    rc = cli.main(["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"], device="cpu")
    err = capsys.readouterr().err
    assert rc != 0 and "no-such-compiler" in err
    assert "Could not open graph file" not in err


BUILD_AND_CHECK = textwrap.dedent("""
    import pathlib, sys
    import numpy as np
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models.csr import (
        CSRGraph,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime import (
        native_loader,
    )
    native_loader.BUILD_DIR = pathlib.Path(sys.argv[1])
    edges = np.random.default_rng(0).integers(0, 500, size=(4000, 2)).astype(np.int32)
    a = CSRGraph.from_edges(500, edges)
    b = CSRGraph.from_edges(500, edges, native=False)
    assert a.col_indices.tobytes() == b.col_indices.tobytes()
    print(native_loader.build().path)
""")


def test_concurrent_first_builds_both_get_a_library(tmp_path):
    """Two processes building into one empty directory at once: both load
    a whole library, and one library is left."""
    build_dir = tmp_path / "build"
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", BUILD_AND_CHECK, str(build_dir)], cwd=REPO_ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for _ in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    assert [p.name for p in build_dir.glob("*.so")] == [os.path.basename(paths.pop())]
    assert not list(build_dir.glob("*.tmp"))


def test_cli_phases_and_numpy_path(tmp_path, capsys):
    """The CLI splits its preprocessing span into load, layout and compile,
    which sum to the reported span; native=False gives the same report but
    for its times."""
    n, edges = generators.rmat_edges(9, edge_factor=8, seed=2)
    gpath, qpath = tmp_path / "g.bin", tmp_path / "q.bin"
    tio.save_graph_bin(gpath, n, edges)
    tio.save_query_bin(qpath, generators.random_queries(n, 6, max_group=4, seed=3))
    argv = ["prog", "-g", str(gpath), "-q", str(qpath), "-gn", "1"]
    reports = []
    for native in (True, False):
        assert cli.main(argv, device="cpu", native=native) == 0
        reports.append(capsys.readouterr().out.splitlines())
        phases = timing.phase_seconds()
        assert sorted(phases) == ["compile", "layout", "load"]
        assert min(phases.values()) >= 0
        span = float(reports[-1][5].split(":", 1)[1].split()[0])
        assert sum(phases.values()) == pytest.approx(span, abs=2e-6)
    assert reports[0][:5] == reports[1][:5]


# ---- gen_cli's native entry points against the JAX package's library.

JAX_LOADER = os.path.join(
    REPO_ROOT, "parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu",
    "runtime", "loader.cpp",
)


@pytest.fixture(scope="module")
def jax_library(tmp_path_factory):
    """The JAX package's native library, built from its loader.cpp with
    its Makefile's flags into a directory of this module's own (so that no
    other test process sees a half-written file), and loaded in place of
    any built one for the module; skips only without a C++ compiler."""
    import shutil

    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler for the JAX package's native library")
    out = tmp_path_factory.mktemp("jax_native") / "librt_loader.so"
    subprocess.run(
        [cxx, "-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
         "-pthread", "-shared", "-o", str(out), JAX_LOADER],
        check=True, capture_output=True,
    )
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_lib_path", lambda: str(out))
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_load_failed", False)
        assert jax_native.available()
        yield jax_native


def _text_files(tmp_path):
    """A .gr file and a SNAP file long enough to split between 8 threads,
    with comments, blank lines, CRLF endings, tabs and extra fields."""
    rng = np.random.default_rng(13)
    arcs = rng.integers(1, 5001, size=(6000, 2))
    gr = ["c generated", "p sp 5000 12000"]
    gr += [f"a {u} {v} {w}" + ("\r" if i % 7 == 0 else "")
           for i, ((u, v), w) in enumerate(zip(arcs, rng.integers(1, 99, 6000)))]
    gr.insert(3000, "c a comment among the arcs")
    pairs = rng.integers(0, 40000, size=(5000, 2))
    snap = ["# Nodes: 40000", "% percent comment", ""]
    snap += [f"{u}\t{v}" if i % 3 else f"{u} {v} 1" for i, (u, v) in enumerate(pairs)]
    snap.insert(2500, "   ")
    (tmp_path / "a.gr").write_text("\n".join(gr) + "\n")
    (tmp_path / "a.txt").write_text("\n".join(snap))  # no final newline
    return str(tmp_path / "a.gr"), str(tmp_path / "a.txt")


@pytest.mark.parametrize("threads", THREADS)
def test_text_parsers_match_jax(jax_library, tmp_path, monkeypatch, threads):
    """msbfs_gr_scan/msbfs_gr_arcs and msbfs_snap_scan/msbfs_snap_pairs:
    the port's arcs and pairs, in file order, equal the JAX library's at
    every thread count, and the Python loops' after canonicalisation."""
    gr, snap = _text_files(tmp_path)
    monkeypatch.setenv("MSBFS_NATIVE_THREADS", threads)
    n, arcs = native_loader.load_gr_arcs(gr)
    jn, jarcs = jax_library.load_gr_arcs(gr)
    assert n == jn == 5000
    _same(arcs, jarcs)
    assert arcs.shape == (6000, 2) and arcs.min() == 0 and arcs.max() <= 4999
    pairs = native_loader.load_snap_pairs(snap)
    _same(pairs, jax_library.load_snap_pairs(snap))
    assert pairs.shape == (5000, 2)
    for native_out, python_out in (
        (tio.load_dimacs_gr(gr), jio.load_dimacs_gr(gr, native=False)),
        (tio.load_edgelist(snap), jio.load_edgelist(snap, native=False)),
    ):
        assert native_out[0] == python_out[0]
        _same(native_out[1], python_out[1])


# (text, gr or snap): each native parser's refusals, with the JAX
# library's messages (rc 1 open, 2 header, 3 malformed, 4 range, 6 int32).
NATIVE_TEXT_ERRORS = {
    "gr_malformed": ("p sp 4 2\na 1 2\na 2 x 1\n", "gr"),
    "gr_fraction": ("p sp 4 2\na 1 2.5 1\n", "gr"),
    "gr_range": ("p sp 4 2\na 1 5 1\n", "gr"),
    "gr_no_header": ("c x\na 1 2 1\n", "gr"),
    "gr_header_token": ("p sp 12x3 9\na 1 2 1\n", "gr"),
    "gr_header_int32": ("p sp 3000000000 2\na 1 2 1\n", "gr"),
    "gr_empty": ("", "gr"),
    "gr_missing": (None, "gr"),
    "snap_malformed": ("1 2\n3 x\n", "snap"),
    "snap_int32": ("1 2\n3000000000 1\n", "snap"),
    "snap_missing": (None, "snap"),
}


@pytest.mark.parametrize("case", sorted(NATIVE_TEXT_ERRORS))
def test_text_parser_errors_match_jax(jax_library, tmp_path, case):
    text, fmt = NATIVE_TEXT_ERRORS[case]
    path = tmp_path / "bad.txt"
    if text is not None:
        path.write_text(text)
    name = "load_gr_arcs" if fmt == "gr" else "load_snap_pairs"
    with pytest.raises(ValueError) as port_err:
        getattr(native_loader, name)(str(path))
    with pytest.raises(ValueError) as jax_err:
        getattr(jax_library, name)(str(path))
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("threads", ["1", "8"])
def test_native_rmat_matches_jax(jax_library, monkeypatch, threads):
    """msbfs_rmat_edges over two 2^20-record chunks: the JAX library's
    records at 1 and 8 threads, through both the wrapper and
    generators.rmat_edges (native=True and MSBFS_NATIVE_RMAT=1)."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
        generators as jgen,
    )

    monkeypatch.setenv("MSBFS_NATIVE_THREADS", threads)
    want = jax_library.rmat_edges(17, 16 << 17, 0.57, 0.19, 0.19, 3)
    _same(native_loader.rmat_edges(17, 16 << 17, 0.57, 0.19, 0.19, 3), want)
    n, edges = generators.rmat_edges(17, edge_factor=16, seed=3, native=True)
    assert n == 1 << 17
    _same(edges, want)
    monkeypatch.setenv("MSBFS_NATIVE_RMAT", "1")
    _same(generators.rmat_edges(17, edge_factor=16, seed=3)[1], want)
    _same(generators.rmat_edges(9, edge_factor=4, seed=8)[1],
          jgen.rmat_edges(9, edge_factor=4, seed=8)[1])
    # native=False stays the NumPy stream, the JAX package's.
    _same(generators.rmat_edges(9, edge_factor=4, seed=8, native=False)[1],
          jgen.rmat_edges(9, edge_factor=4, seed=8, native=False)[1])
    with pytest.raises(ValueError, match="rc=2"):
        native_loader.rmat_edges(4, 8, 0.6, 0.3, 0.3, 0)


def test_native_gen_cli_matches_jax(jax_library, tmp_path, monkeypatch, capsys):
    """gen_cli --kind rmat under MSBFS_NATIVE_RMAT=1: the JAX gen_cli's
    graph, byte for byte."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
        gen_cli as jgen_cli,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import (
        gen_cli,
    )

    monkeypatch.setenv("MSBFS_NATIVE_RMAT", "1")
    for main, name in ((gen_cli.main, "port.bin"), (jgen_cli.main, "jax.bin")):
        assert main(["--kind", "rmat", "--scale", "11", "--graph", str(tmp_path / name)]) == 0
    capsys.readouterr()
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_native_rmat_without_compiler_raises(fresh_build, monkeypatch, tmp_path):
    """MSBFS_NATIVE_RMAT=1 with no library to build raises; it never gives
    the NumPy stream instead."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setenv("MSBFS_NATIVE_RMAT", "1")
    with pytest.raises(native_loader.NativeBuildError, match="no-such-compiler"):
        generators.rmat_edges(6, edge_factor=2, seed=1)
    with pytest.raises(native_loader.NativeBuildError):
        tio.load_edgelist(str(tmp_path / "absent.txt"))


def test_hub_tail_and_components_match_jax():
    """hub_tail_edges, component_labels (whole and sampled: a sample_cap
    below the record count draws with replacement from default_rng(seed))
    and ensure_giant_sources: the JAX package's arrays."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.models import (
        generators as jgen,
    )

    for args in ((), (40, 9), (1, 3)):
        n, e = generators.hub_tail_edges(*args)
        jn, je = jgen.hub_tail_edges(*args)
        assert n == jn
        _same(e, je)
    n, edges = generators.gnm_edges(3000, 1700, seed=4)  # many components
    edges = np.concatenate([edges, [[-1, 2], [5, 3000]]])  # dropped endpoints
    for cap, seed in ((1 << 24, 0), (900, 0), (900, 7)):
        labels = generators.component_labels(n, edges, sample_cap=cap, seed=seed)
        _same(labels, jgen.component_labels(n, edges, sample_cap=cap, seed=seed))
    full = generators.component_labels(n, edges)
    sampled = generators.component_labels(n, edges, sample_cap=900)
    # A sample only splits components: one sampled label, one true one.
    for lab in np.unique(sampled):
        assert len(np.unique(full[sampled == lab])) == 1
    queries = generators.random_queries(n, 30, max_group=3, seed=2)
    queries[4] = np.zeros(0, np.int32)
    queries[5] = np.array([-1, 4000], np.int32)
    for seed in (0, 9):
        got = generators.ensure_giant_sources(queries, n, edges, seed=seed)
        want = jgen.ensure_giant_sources(queries, n, edges, seed=seed)
        assert len(got) == len(want) == 30
        for a, b in zip(got, want):
            _same(a, b)
    assert queries[4].size == 0  # the input is not mutated
