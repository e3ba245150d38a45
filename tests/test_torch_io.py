"""The port's binary I/O against the JAX package's, on the same files."""

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
