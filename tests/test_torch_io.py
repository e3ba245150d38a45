"""The port's binary I/O and its DIMACS/SNAP text readers against the JAX
package's, on the same files."""

import struct

import numpy as np
import pytest

from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.runtime import (
    native_loader as jax_native,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
    io as jio,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.models import (
    generators,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.runtime.supervisor import (
    InputError,
)
from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
    io as tio,
)


def _same_csr(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    np.testing.assert_array_equal(a.row_offsets, b.row_offsets)
    np.testing.assert_array_equal(a.col_indices, b.col_indices)
    assert a.row_offsets.dtype == np.int64


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_round_trip_matches_jax(tmp_path, weighted):
    n, edges = generators.road_edges(17, 23, seed=3)
    edges = np.concatenate([edges, [[4, 4], [5, 9], [5, 9]]]).astype(np.int32)
    weights = (
        np.random.default_rng(0).integers(1, 9, size=len(edges)) if weighted else None
    )
    path = tmp_path / "g.bin"
    tio.save_graph_bin(path, n, edges, weights)
    got = tio.load_graph_bin(path)
    _same_csr(got, jio.load_graph_bin(path, native=False))
    # The JAX writer's file reads back identically through the port.
    path2 = tmp_path / "g2.bin"
    jio.save_graph_bin(path2, n, edges, weights)
    assert path.read_bytes() == path2.read_bytes()
    assert got.num_directed_edges == 2 * len(edges)


def test_query_round_trip_and_padding(tmp_path):
    queries = generators.random_queries(1000, 7, max_group=9, seed=5)
    queries[3] = np.zeros(0, dtype=np.int32)
    path = tmp_path / "q.bin"
    tio.save_query_bin(path, queries)
    got = tio.load_query_bin(path)
    want = jio.load_query_bin(path)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.pad_queries(got), jio.pad_queries(want))
    np.testing.assert_array_equal(
        tio.pad_queries(got, pad_to=12), jio.pad_queries(want, pad_to=12)
    )
    assert tio.pad_queries([]).shape == jio.pad_queries([]).shape == (0, 1)
    with pytest.raises(ValueError):
        tio.pad_queries(got, pad_to=2)


def _graph_bytes(n, m, edges=b"", tail=b""):
    return struct.pack("<iq", n, m) + edges + tail


BAD_GRAPHS = {
    "truncated_header": (b"\x01\x00", IOError),
    "negative_n": (_graph_bytes(-3, 0), IOError),
    "truncated_edges": (_graph_bytes(4, 3, np.zeros(4, np.int32).tobytes()), IOError),
    "bad_weight_magic": (
        _graph_bytes(4, 1, np.array([0, 1], np.int32).tobytes(), b"XXXX\x01\x00\x00\x00"),
        IOError,
    ),
    "short_weight_section": (
        _graph_bytes(4, 1, np.array([0, 1], np.int32).tobytes(), b"MSBW\x01"),
        IOError,
    ),
    "zero_weight": (
        _graph_bytes(4, 1, np.array([0, 1], np.int32).tobytes(), b"MSBW" + bytes(4)),
        IOError,
    ),
    "endpoint_out_of_range": (
        _graph_bytes(4, 1, np.array([0, 9], np.int32).tobytes()),
        ValueError,
    ),
    "weighted_endpoint_out_of_range": (
        _graph_bytes(
            4, 1, np.array([0, 9], np.int32).tobytes(),
            b"MSBW" + np.array([1], np.int32).tobytes(),
        ),
        ValueError,
    ),
}


# Where the native decoder's error differs from the NumPy decoder's: what
# the JAX package's native decoder raises (its runtime/native_loader.py).
# A weighted file decodes with NumPy in the JAX package, so its errors are
# the NumPy decoder's for both.
NATIVE_ERRORS = {
    "endpoint_out_of_range": (IOError, "native loader: failed to decode {path} (rc=4)"),
}
# Each case once per decoder: the NumPy decoder (native=False, held to the
# JAX package's native=False) under the case's name, the native decoder
# (the default, held to the JAX package's default, which is its native
# decoder where its library is built) as "native-<case>".
DECODER_CASES = [pytest.param(False, case, id=case) for case in sorted(BAD_GRAPHS)] + [
    pytest.param(True, case, id=f"native-{case}") for case in sorted(BAD_GRAPHS)
]


@pytest.mark.parametrize("native, case", DECODER_CASES)
def test_graph_load_errors_match_jax(tmp_path, native, case):
    """Each decoder of the port raises what the same decoder of the JAX
    package raises.  The JAX package's native decoder is compared where its
    library is built (this test never builds it); elsewhere its error is
    the one its source states (NATIVE_ERRORS)."""
    data, exc = BAD_GRAPHS[case]
    if native and case in NATIVE_ERRORS:
        exc = NATIVE_ERRORS[case][0]
    path = tmp_path / "bad.bin"
    path.write_bytes(data)
    with pytest.raises(exc) as port_err:
        tio.load_graph_bin(path, native=native)
    if native and case in NATIVE_ERRORS and not jax_native.available():
        want = NATIVE_ERRORS[case][1].format(path=path)
    else:
        with pytest.raises(exc) as jax_err:
            jio.load_graph_bin(path, native=None if native else False)
        assert type(port_err.value) is type(jax_err.value)
        want = str(jax_err.value)
    assert str(port_err.value) == want


BAD_QUERIES = {
    "empty": b"",
    "missing_group": bytes([2, 1]) + np.array([5], np.int32).tobytes(),
    "truncated_group": bytes([1, 3]) + np.array([5], np.int32).tobytes(),
}


@pytest.mark.parametrize("case", sorted(BAD_QUERIES))
def test_query_load_errors_match_jax(tmp_path, case):
    path = tmp_path / "bad.q"
    path.write_bytes(BAD_QUERIES[case])
    with pytest.raises(IOError) as port_err:
        tio.load_query_bin(path)
    with pytest.raises(IOError) as jax_err:
        jio.load_query_bin(path)
    assert str(port_err.value) == str(jax_err.value)


def test_missing_file_raises_oserror(tmp_path):
    with pytest.raises(OSError):
        tio.load_graph_bin(tmp_path / "absent.bin")
    with pytest.raises(OSError):
        tio.load_query_bin(tmp_path / "absent.q")


def test_writer_limits():
    with pytest.raises(ValueError):
        tio.save_query_bin("/dev/null", [[1]] * 256)
    with pytest.raises(ValueError):
        tio.save_query_bin("/dev/null", [list(range(256))])
    with pytest.raises(ValueError):
        tio.save_graph_bin("/dev/null", 3, np.zeros((2, 3), np.int32))


# ---- the text formats gen_cli converts: DIMACS .gr and SNAP edge lists.

GR_TEXT = """c a road fragment: both arc directions, a repeated arc, costs
c that differ per direction, a tab-free arc with trailing fields
p sp 9 14
a 1 2 5
a 2 1 5
a 2 3 1
a 3 2 4
a 3 3 2
a 4 5 9 extra fields
a 5 4 9
a 9 1 3
a 1 9 3
a 6 7 2
a 6 7 1
a 7 8 6
a 8 7 6
a 2 3 8
"""

SNAP_TEXT = """# Directed graph (each unordered pair no more than once): toy.txt
% a second comment style

0\t1
1\t0
2 3
3 7 ignored
7 7

5 2
"""


def _write(path, text, gz=False):
    if gz:
        import gzip

        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        path.write_text(text)
    return path


def _same_parse(a, b):
    assert len(a) == len(b)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("native", [None, True, False])
@pytest.mark.parametrize("keep_weights", [False, True])
def test_load_dimacs_gr_matches_jax(tmp_path, native, gz, keep_weights):
    path = _write(tmp_path / ("r.gr.gz" if gz else "r.gr"), GR_TEXT, gz)
    want = jio.load_dimacs_gr(path, native=False, keep_weights=keep_weights)
    if native and (gz or keep_weights):
        # The JAX package's typed refusals, kept.
        with pytest.raises(InputError):
            tio.load_dimacs_gr(path, native=native, keep_weights=keep_weights)
        return
    got = tio.load_dimacs_gr(path, native=native, keep_weights=keep_weights)
    _same_parse(got, want)
    if keep_weights:
        # The least cost of each pair: 2-3 has 1, 4 and 8; 6-7 has 2 and 1.
        pairs = [tuple(p) for p in got[1]]
        assert got[2][pairs.index((1, 2))] == 1 and got[2][pairs.index((5, 6))] == 1


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("native", [None, True, False])
def test_load_edgelist_matches_jax(tmp_path, native, gz):
    path = _write(tmp_path / ("e.txt.gz" if gz else "e.txt"), SNAP_TEXT, gz)
    want = jio.load_edgelist(path, native=False)
    if native and gz:
        with pytest.raises(InputError, match="cannot read .gz"):
            tio.load_edgelist(path, native=True)
        return
    _same_parse(tio.load_edgelist(path, native=native), want)


def test_save_dimacs_gr_matches_jax_and_reads_back(tmp_path):
    n, edges = generators.road_edges(13, 7, seed=2)
    a, b = tmp_path / "port.gr", tmp_path / "jax.gr"
    assert tio.save_dimacs_gr(a, n, edges, comment="x\ny") == 2 * len(edges)
    jio.save_dimacs_gr(b, n, edges, comment="x\ny")
    assert a.read_bytes() == b.read_bytes()
    for native in (True, False):
        got_n, got = tio.load_dimacs_gr(a, native=native)
        key = np.unique(np.sort(edges, axis=1).astype(np.int64) @ np.array([1 << 32, 1]))
        assert got_n == n
        np.testing.assert_array_equal(got.astype(np.int64) @ np.array([1 << 32, 1]), key)
    with pytest.raises(ValueError) as port_err:
        tio.save_dimacs_gr(a, n, edges[:, :1])
    with pytest.raises(ValueError) as jax_err:
        jio.save_dimacs_gr(b, n, edges[:, :1])
    assert str(port_err.value) == str(jax_err.value)


# (format, text): files both readers refuse, each parser with its class.
BAD_TEXT = {
    "gr_token": ("gr", "p sp 4 2\na 1 x 1\n"),
    "gr_fraction": ("gr", "p sp 4 2\na 1 2.5 1\n"),
    "gr_short_arc": ("gr", "p sp 4 2\na 1\n"),
    "gr_out_of_range": ("gr", "p sp 4 2\na 1 9 1\n"),
    "gr_no_header": ("gr", "c only\na 1 2 1\n"),
    "gr_beyond_int32": ("gr", "p sp 4 2\na 1 3000000000 1\n"),
    "gr_zero_cost": ("gr_weights", "p sp 4 2\na 1 2 0\n"),
    "snap_token": ("snap", "1 2\n3 four\n"),
    "snap_single_id": ("snap", "1 2\n7\n"),
    "snap_beyond_int32": ("snap", "1 2\n3000000000 1\n"),
    "snap_negative": ("snap", "1 2\n-3 1\n"),
    "snap_empty": ("snap", "# nothing\n\n"),
}


def _read(mod, fmt, path, native):
    if fmt == "snap":
        return mod.load_edgelist(path, native=native)
    return mod.load_dimacs_gr(path, native=native, keep_weights=fmt == "gr_weights")


@pytest.mark.parametrize("case", sorted(BAD_TEXT))
def test_malformed_text_raises_as_jax(tmp_path, case):
    fmt, text = BAD_TEXT[case]
    path = _write(tmp_path / "bad.txt", text)
    with pytest.raises((ValueError, OverflowError)) as jax_err:
        _read(jio, fmt, path, native=False)
    # The Python loop raises what the JAX package's raises.
    with pytest.raises(type(jax_err.value)):
        _read(tio, fmt, path, native=False)
    if fmt != "gr_weights":
        # The native parser names the fault as a ValueError (rc 3, 4, 6).
        with pytest.raises(ValueError):
            _read(tio, fmt, path, native=True)


def test_keep_weights_feeds_the_weighted_route(tmp_path, capsys, monkeypatch):
    """load_dimacs_gr(keep_weights=True) -> save_graph_bin(weights=) ->
    MSBFS_WEIGHTED=1: the port's CLI reads the costs, and answers as the
    JAX CLI on the same file."""
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu import (
        cli as jcli,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu.utils import (
        faults as jfaults,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch import (
        cli as tcli,
    )
    from parallel_multi_source_bfs_implementation_using_mpi_and_cuda_tpu_torch.utils import (
        faults as tfaults,
    )

    n, pairs, w = tio.load_dimacs_gr(_write(tmp_path / "r.gr", GR_TEXT), keep_weights=True)
    g, q = tmp_path / "g.bin", tmp_path / "q.bin"
    tio.save_graph_bin(g, n, pairs, weights=w)
    assert tio.load_graph_bin(g).edge_weights is not None
    tio.save_query_bin(q, [[0], [6], [2, 8]])
    argv = ["prog", "-g", str(g), "-q", str(q), "-gn", "1"]
    monkeypatch.setenv("MSBFS_WEIGHTED", "1")
    try:
        assert tcli.main(argv, device="cpu") == 0
        port = capsys.readouterr().out.splitlines()
        assert jcli.main(argv) == 0
        jax = capsys.readouterr().out.splitlines()
    finally:
        # Neither CLI leaves its fault plan installed for the next test.
        tfaults.activate(None)
        jfaults.activate(None)
    assert port[:5] == jax[:5]
