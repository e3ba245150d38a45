"""The port's gen_cli against the JAX package's, in process, on the same
argv: the files each writes (graph, query, cost section, deltas) byte for
byte, the stderr lines and the exit codes, for every kind, every
``--convert`` format (plain and ``.gz``), every flag error and a
malformed convert input.  Each CLI runs in a directory of its own with
relative paths, so that the two stderr streams can be compared whole."""

import gzip
import hashlib

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
    gen_cli as jgen,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import (
    gen_cli as tgen,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)

OUTPUTS = ("g.bin", "q.bin", "d.bin")


def _run(main, argv, where, monkeypatch, capsys):
    """(exit code, stderr, {output: sha256}) of ``main(argv)`` run in
    ``where``; an argparse exit counts by its code."""
    where.mkdir(exist_ok=True)
    monkeypatch.chdir(where)
    try:
        rc = main(argv)
    except SystemExit as exc:
        rc = exc.code
    err = capsys.readouterr().err
    files = {
        name: hashlib.sha256((where / name).read_bytes()).hexdigest()
        for name in OUTPUTS if (where / name).exists()
    }
    return rc, err, files


def _both(argv, tmp_path, monkeypatch, capsys):
    jax = _run(jgen.main, argv, tmp_path / "jax", monkeypatch, capsys)
    port = _run(tgen.main, argv, tmp_path / "port", monkeypatch, capsys)
    return port, jax


@pytest.mark.parametrize("weights", ["uniform", "zipf"])
@pytest.mark.parametrize("kind", ["rmat", "grid", "road", "gnm"])
def test_generate_matches_jax(kind, weights, tmp_path, monkeypatch, capsys):
    argv = [
        "--kind", kind, "--scale", "10", "--edge-factor", "4", "--graph", "g.bin",
        "--queries", "9", "--max-group", "7", "--query-file", "q.bin",
        "--deltas", "d.bin", "--delta-batches", "3", "--delta-size", "6",
        "--weights", weights, "--max-cost", "11", "--seed", "5",
    ]
    port, jax = _both(argv, tmp_path, monkeypatch, capsys)
    assert port == jax
    assert port[0] == 0 and set(port[2]) == set(OUTPUTS)
    assert f"weights={weights}[1,11]" in port[1]


def _text_fixtures(tmp_path):
    """A DIMACS .gr (comments, both arc directions, a duplicate arc, an
    isolated top vertex, costs) and a SNAP list (comment styles, blank
    lines, both directions, a repeated pair, a self-loop), plain and gzipped."""
    n, edges = generators.road_edges(9, 11, seed=4)
    gr = tmp_path / "road.gr"
    tio.save_dimacs_gr(gr, n + 1, edges, comment="road 9x11\nseed 4")
    with open(gr, "a") as f:
        f.write("a 3 4 7\n")
    snap = tmp_path / "web.txt"
    rng = np.random.default_rng(8)
    pairs = rng.integers(0, 300, size=(700, 2))
    lines = ["# Directed graph: web.txt", "% other comment", ""]
    lines += [f"{u}\t{v}" for u, v in pairs]
    lines += [f"{v} {u}" for u, v in pairs[:50]] + ["5 5", "   ", "12 13 extra"]
    snap.write_text("\n".join(lines) + "\n")
    out = {"dimacs": gr, "snap": snap}
    for fmt, path in list(out.items()):
        gz = path.with_name(path.name + ".gz")
        with open(path, "rb") as src, gzip.open(gz, "wb") as dst:
            dst.write(src.read())
        out[fmt + ".gz"] = gz
    return out


@pytest.mark.parametrize("extra", [[], ["--scale", "12", "--kind", "grid"]])
@pytest.mark.parametrize("fmt", ["dimacs", "dimacs.gz", "snap", "snap.gz"])
def test_convert_matches_jax(fmt, extra, tmp_path, monkeypatch, capsys):
    src = _text_fixtures(tmp_path)[fmt]
    argv = [
        "--convert", str(src), "--informat", fmt.split(".")[0], "--graph", "g.bin",
        "--queries", "4", "--query-file", "q.bin", "--weights", "uniform", *extra,
    ]
    port, jax = _both(argv, tmp_path, monkeypatch, capsys)
    assert port == jax
    assert port[0] == 0 and set(port[2]) == {"g.bin", "q.bin"}
    assert ("ignoring generation flags: --kind, --scale" in port[1]) == bool(extra)


FLAG_ERRORS = {
    "queries_without_file": ["--queries", "5"],
    "file_without_queries": ["--query-file", "q.bin"],
    "too_many_queries": ["--queries", "256", "--query-file", "q.bin"],
    "group_too_large": ["--queries", "5", "--query-file", "q.bin", "--max-group", "129"],
    "zero_delta_batches": ["--deltas", "d.bin", "--delta-batches", "0"],
    "zero_delta_size": ["--deltas", "d.bin", "--delta-size", "0"],
    "locality_above_one": ["--deltas", "d.bin", "--delta-locality", "1.5"],
    "max_cost_zero": ["--weights", "zipf", "--max-cost", "0"],
    "unknown_kind": ["--kind", "tree"],
    "unknown_informat": ["--convert", "x.gr", "--informat", "xml"],
    "unknown_weights": ["--weights", "pareto"],
    "scale_not_int": ["--scale", "ten"],
    "missing_graph": None,
}


@pytest.mark.parametrize("case", sorted(FLAG_ERRORS))
def test_flag_errors_match_jax(case, tmp_path, monkeypatch, capsys):
    argv = FLAG_ERRORS[case]
    argv = ["--kind", "grid", "--scale", "4"] if argv is None else ["--graph", "g.bin", *argv]
    port, jax = _both(argv, tmp_path, monkeypatch, capsys)
    assert port == jax
    assert port[0] == 2 and port[1] and not port[2]


MALFORMED = {
    "gr_token": ("dimacs", "p sp 4 2\na 1 x 1\n"),
    "gr_fraction": ("dimacs", "p sp 4 2\na 1 2.5 1\n"),
    "gr_short_arc": ("dimacs", "p sp 4 2\na 1\n"),
    "gr_out_of_range": ("dimacs", "p sp 4 2\na 1 9 1\n"),
    "gr_zero_endpoint": ("dimacs", "p sp 4 2\na 0 2 1\n"),
    "gr_no_header": ("dimacs", "c nothing\na 1 2 1\n"),
    "snap_token": ("snap", "1 2\n3 four\n"),
    "snap_fraction": ("snap", "1 2\n1.5 2\n"),
    "snap_single_id": ("snap", "1 2\n7\n"),
    "snap_beyond_int32": ("snap", "1 2\n3000000000 1\n"),
    "snap_no_edges": ("snap", "# only a comment\n\n"),
    "snap_negative": ("snap", "1 2\n-3 1\n"),
    "missing_file": ("dimacs", None),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_convert_exits_1_as_jax(case, tmp_path, monkeypatch, capsys):
    fmt, text = MALFORMED[case]
    src = tmp_path / f"{case}.txt"
    if text is not None:
        src.write_text(text)
    argv = ["--convert", str(src), "--informat", fmt, "--graph", "g.bin"]
    port, jax = _both(argv, tmp_path, monkeypatch, capsys)
    assert port[0] == jax[0] == 1
    assert not port[2] and not jax[2]
    assert port[1].startswith("convert failed: ") and jax[1].startswith("convert failed: ")
