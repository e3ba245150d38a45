"""Binary graph/query I/O, byte-for-byte compatible with the reference formats.

Graph format (reference LoadGraphBin, main.cu:92-130):
    int32  n                      -- vertex count
    int64  m                      -- undirected edge count
    m x (int32 u, int32 v)        -- edge records
optionally followed by one weight section (:data:`WEIGHT_MAGIC` then m
positive int32 costs): the graph's ``edge_weights``, which only the
weighted route reads.

Query format (reference LoadQueryBin, main.cu:134-164):
    uint8  K                      -- number of query groups
    per group: uint8 set_size, then set_size x int32 vertex ids

Each loader trips its fault seam (``load_graph``, ``load_query``;
utils/faults.py) before it reads anything.  The edge records decode in
the native runtime (runtime/native_loader.py)
unless the caller passes ``native=False``.  Each decoder raises what the
same decoder of the JAX package raises: ``IOError`` for a truncated or
corrupt file from both; for an out-of-range endpoint the native decoder's
``IOError`` ("native loader: failed to decode ... (rc=4)") and the NumPy
decoder's ``ValueError``.  The JAX package decodes a weighted file with
NumPy only, so there the native decoder raises the NumPy decoder's
``ValueError``.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Sequence

import numpy as np

from ..models.csr import CSRGraph
from .faults import trip

GRAPH_HEADER = struct.Struct("<iq")  # int32 n, int64 m
WEIGHT_MAGIC = b"MSBW"


def _graph_bin_layout(path: str | os.PathLike):
    """(n, m, weighted) after full fail-before-allocate validation of the
    header, the edge-list size, and any trailing weight section: a
    bit-flipped header must never turn into a huge allocation."""
    with open(path, "rb") as f:
        header = f.read(GRAPH_HEADER.size)
        if len(header) < GRAPH_HEADER.size:
            raise IOError(f"truncated graph header in {path}")
        n, m = GRAPH_HEADER.unpack(header)
        if n < 0 or m < 0:
            raise IOError(f"corrupt graph header in {path}: n={n}, m={m}")
        remaining = os.fstat(f.fileno()).st_size - GRAPH_HEADER.size
        if remaining < 8 * m:
            raise IOError(
                f"truncated edge list in {path}: header claims {m} edges "
                f"({8 * m} bytes), file has {remaining}"
            )
        extra = remaining - 8 * m
        if extra == 0:
            return n, m, False
        if extra != len(WEIGHT_MAGIC) + 4 * m:
            raise IOError(
                f"corrupt weight section in {path}: {extra} trailing "
                f"bytes, expected {len(WEIGHT_MAGIC) + 4 * m} "
                f"(magic + {m} int32 costs) or none"
            )
        f.seek(GRAPH_HEADER.size + 8 * m)
        magic = f.read(len(WEIGHT_MAGIC))
        if magic != WEIGHT_MAGIC:
            raise IOError(
                f"corrupt weight section in {path}: bad magic {magic!r}"
            )
        return n, m, True


def _read_weights(f, path, m: int) -> np.ndarray:
    """Read the weight section at ``f``'s position (after the magic) and
    refuse it unless it holds m costs >= 1."""
    weights = np.fromfile(f, dtype=np.int32, count=m)
    if weights.size != m:
        raise IOError(f"truncated weight section in {path}")
    if m and weights.min() < 1:
        raise IOError(f"corrupt weight section in {path}: costs must be >= 1")
    return weights


def load_graph_bin(path: str | os.PathLike, native: bool = True) -> CSRGraph:
    """Load a reference-format binary graph into a host CSR: validated
    before anything is allocated, then decoded by the native runtime or,
    with ``native=False``, by one NumPy read.
    A weight section is validated (costs >= 1) and kept as the graph's
    ``edge_weights``, a cost beside each directed slot.  The
    ``load_graph`` fault seam (utils/faults.py) trips first, before any
    decode."""
    trip("load_graph")
    n, m, weighted = _graph_bin_layout(path)
    weights = None
    if native:
        if weighted:
            with open(path, "rb") as f:
                f.seek(GRAPH_HEADER.size + 8 * m + len(WEIGHT_MAGIC))
                weights = _read_weights(f, path, m)
        from ..runtime import native_loader

        # The JAX package decodes a weighted file with NumPy: its errors.
        return native_loader.load_graph_csr(
            os.fspath(path), numpy_errors=weighted, weights=weights
        )
    with open(path, "rb") as f:
        f.seek(GRAPH_HEADER.size)
        edges = np.fromfile(f, dtype=np.int32, count=2 * m)
        if edges.size != 2 * m:
            raise IOError(
                f"truncated edge list in {path}: wanted {2*m} ints, "
                f"got {edges.size}"
            )
        if weighted:
            f.seek(len(WEIGHT_MAGIC), os.SEEK_CUR)
            weights = _read_weights(f, path, m)
    return CSRGraph.from_edges(n, edges.reshape(m, 2), native=False, weights=weights)


def save_graph_bin(
    path: str | os.PathLike,
    n: int,
    edges: np.ndarray,
    weights: Optional[np.ndarray] = None,
) -> None:
    """Write the reference graph format from an (m, 2) int array, with an
    optional trailing weight section ((m,) positive int32 costs)."""
    edges = np.ascontiguousarray(np.asarray(edges, dtype=np.int32))
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError("edges must be (m, 2)")
    if weights is not None:
        weights = np.ascontiguousarray(np.asarray(weights, dtype=np.int32))
        if weights.shape != (edges.shape[0],):
            raise ValueError(
                f"weights must be ({edges.shape[0]},), got {weights.shape}"
            )
        if weights.size and weights.min() < 1:
            raise ValueError("edge weights must be >= 1")
    with open(path, "wb") as f:
        f.write(GRAPH_HEADER.pack(int(n), int(edges.shape[0])))
        edges.tofile(f)
        if weights is not None:
            f.write(WEIGHT_MAGIC)
            weights.tofile(f)


def load_query_bin(path: str | os.PathLike) -> List[np.ndarray]:
    """Load the reference query format -> list of K int32 arrays (ragged),
    after the ``load_query`` fault seam (utils/faults.py)."""
    trip("load_query")
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 1:
        raise IOError(f"empty query file {path}")
    k = data[0]
    queries: List[np.ndarray] = []
    off = 1
    for _ in range(k):
        if off >= len(data):
            raise IOError(f"truncated query file {path}")
        size = data[off]
        off += 1
        if len(data) - off < 4 * size:
            raise IOError(f"truncated query group in {path}")
        ids = np.frombuffer(data, dtype=np.int32, count=size, offset=off)
        off += 4 * size
        queries.append(ids.copy())
    return queries


def save_query_bin(path: str | os.PathLike, queries: Sequence[Sequence[int]]) -> None:
    """Write the reference query format (uint8 K, per-group uint8 size + int32s)."""
    if len(queries) > 255:
        raise ValueError("K must fit in uint8 (reference main.cu:143-145)")
    with open(path, "wb") as f:
        f.write(bytes([len(queries)]))
        for q in queries:
            q = np.asarray(q, dtype=np.int32)
            if q.size > 255:
                raise ValueError("group size must fit in uint8 (main.cu:150-152)")
            f.write(bytes([q.size]))
            q.tofile(f)


def pad_queries(
    queries: Sequence[Sequence[int]], pad_to: Optional[int] = None
) -> np.ndarray:
    """Pad ragged query groups to a (K, S) int32 array with -1 fill.
    -1 is dropped by the source init exactly as the reference's bounds
    check drops it (main.cu:46-51).  ``pad_to`` overrides S."""
    K = len(queries)
    max_s = max((len(q) for q in queries), default=0)
    S = pad_to if pad_to is not None else max(max_s, 1)
    if S < max_s:
        raise ValueError(f"pad_to={S} < largest group size {max_s}")
    out = np.full((K, S), -1, dtype=np.int32)
    for i, q in enumerate(queries):
        out[i, : len(q)] = np.asarray(q, dtype=np.int32)
    return out
