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

The public text formats that gen_cli converts: DIMACS ``.gr``
(:func:`load_dimacs_gr`, :func:`save_dimacs_gr`) and SNAP edge lists
(:func:`load_edgelist`), parsed in the native runtime when the file is
plain text and by a Python line loop when it is ``.gz`` or the caller
passes ``native=False``; both give the same edges and refuse the same
files.
"""

from __future__ import annotations

import os
import struct
from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np

from .faults import trip

if TYPE_CHECKING:
    from ..models.csr import CSRGraph

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
    from ..models.csr import CSRGraph

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


def _open_text(path: str | os.PathLike):
    """Open a text dataset, decompressing a ``.gz`` file."""
    if os.fspath(path).endswith(".gz"):
        import gzip

        return gzip.open(path, "rt")
    return open(path, "r")


def _canonical_undirected(edges: np.ndarray) -> np.ndarray:
    """Arc list -> sorted unique undirected edges (u <= v), int32.

    Public datasets list both directions of a segment (DIMACS) or mix
    conventions (SNAP); the reference format holds each undirected edge
    once and doubles it at load (main.cu:106-116).  Dropping duplicate
    arcs changes no distance and no F.  One packed int64 key per pair
    (ids are int32, so lo << 32 | hi is exact) sorts natively."""
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
    keys = np.unique((lo << 32) | hi)
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1).astype(np.int32)


def _canonical_undirected_weighted(edges: np.ndarray, weights: np.ndarray):
    """:func:`_canonical_undirected` with the least cost among each
    pair's arcs, the one choice that keeps every shortest path."""
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
    keys = (lo << 32) | hi
    order = np.argsort(keys, kind="stable")
    ks, ws = keys[order], np.asarray(weights, dtype=np.int64)[order]
    uniq, start = np.unique(ks, return_index=True)
    wmin = np.minimum.reduceat(ws, start) if uniq.size else ws[:0]
    pairs = np.stack([uniq >> 32, uniq & 0xFFFFFFFF], axis=1).astype(np.int32)
    return pairs, wmin.astype(np.int32)


def _native_text_parse(path, native, parse, label):
    """The text readers' one choice of parser: the native one on a plain
    text file unless ``native=False``; the Python loop (``None`` returned)
    on a ``.gz`` file, where ``native=True`` is an :class:`InputError`.
    ``parse(native_loader)`` runs the native parse.  The native runtime is
    built at first use; a runtime that cannot be built raises."""
    gz = os.fspath(path).endswith(".gz")
    if native is False or (native is None and gz):
        return None
    if gz:
        from ..runtime.supervisor import InputError

        raise InputError(f"native {label} parser cannot read .gz files")
    from ..runtime import native_loader

    return parse(native_loader)


def load_dimacs_gr(
    path: str | os.PathLike,
    native: Optional[bool] = None,
    keep_weights: bool = False,
):
    """Parse a DIMACS shortest-path ``.gr`` file (USA-road-d family) into
    (n, edges) for :func:`save_graph_bin`.

    Format: comment lines ``c ...``, one ``p sp <n> <m>`` header (the last
    one wins), arc lines ``a <u> <v> <w>`` with 1-based endpoints.  Costs
    are dropped (the objective counts hops, main.cu:30-32) unless
    ``keep_weights``, which returns (n, edges, weights) for the weighted
    route, the least cost per pair, every cost >= 1; it reads on the
    Python path, so ``native=True`` with it is an :class:`InputError`.
    Arcs become sorted unique undirected edges.  ``native`` as
    :func:`_native_text_parse` decides; ``ValueError`` (``OverflowError``
    for an id beyond int32 on the Python path) on a malformed file."""
    if keep_weights and native:
        from ..runtime.supervisor import InputError

        raise InputError(
            "native DIMACS .gr parser drops the cost column; "
            "keep_weights needs native=False"
        )
    parsed = None if keep_weights else _native_text_parse(
        path, native, lambda nl: nl.load_gr_arcs(os.fspath(path)), "DIMACS .gr"
    )
    if parsed is not None:
        n, arcs = parsed
        return n, _canonical_undirected(arcs)
    n = None
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    wsl: List[np.ndarray] = []
    chunk_u: List[int] = []
    chunk_v: List[int] = []
    chunk_w: List[int] = []
    with _open_text(path) as f:
        for line in f:
            if line.startswith("a "):
                _, u, v, *rest = line.split()
                chunk_u.append(int(u))
                chunk_v.append(int(v))
                if keep_weights:
                    chunk_w.append(int(rest[0]) if rest else 1)
                if len(chunk_u) >= 1 << 20:
                    # int32 buffers halve the peak on the large public
                    # files; an id beyond int32 raises OverflowError here.
                    us.append(np.asarray(chunk_u, dtype=np.int32))
                    vs.append(np.asarray(chunk_v, dtype=np.int32))
                    wsl.append(np.asarray(chunk_w, dtype=np.int32))
                    chunk_u, chunk_v, chunk_w = [], [], []
            elif line.startswith("p "):
                n = int(line.split()[2])
    if n is None:
        raise ValueError(f"{path}: no 'p sp <n> <m>' header line")
    us.append(np.asarray(chunk_u, dtype=np.int32))
    vs.append(np.asarray(chunk_v, dtype=np.int32))
    wsl.append(np.asarray(chunk_w, dtype=np.int32))
    arcs = np.stack([np.concatenate(us), np.concatenate(vs)], axis=1) - 1
    if arcs.size and (arcs.min() < 0 or arcs.max() >= n):
        raise ValueError(f"{path}: arc endpoint outside 1..{n}")
    if not keep_weights:
        return n, _canonical_undirected(arcs)
    weights = np.concatenate(wsl)
    if weights.size and weights.min() < 1:
        raise ValueError(f"{path}: arc costs must be >= 1 for keep_weights")
    pairs, wmin = _canonical_undirected_weighted(arcs, weights)
    return n, pairs, wmin


def save_dimacs_gr(
    path: str | os.PathLike, n: int, edges: np.ndarray, comment: str = ""
) -> int:
    """Write a DIMACS ``.gr`` file from an (m, 2) undirected edge array
    in the USA-road-d convention (both arc directions, cost 1), each
    ``comment`` line as a ``c`` line; returns the arc lines written
    (2m).  :func:`load_dimacs_gr` reads it back."""
    edges = np.asarray(edges)
    if edges.ndim != 2 or edges.shape[1] != 2:
        raise ValueError("edges must be (m, 2)")
    m = int(edges.shape[0])
    with open(path, "w") as f:
        if comment:
            for line in comment.splitlines():
                f.write(f"c {line}\n")
        f.write(f"p sp {int(n)} {2 * m}\n")
        chunk = 1 << 20
        for lo in range(0, m, chunk):
            part = edges[lo : lo + chunk].astype(np.int64) + 1  # 1-based
            both = np.empty((2 * part.shape[0], 2), dtype=np.int64)
            both[0::2] = part
            both[1::2] = part[:, ::-1]
            np.savetxt(f, both, fmt="a %d %d 1")
    return 2 * m


def load_edgelist(path: str | os.PathLike, native: Optional[bool] = None):
    """Parse a SNAP whitespace edge list (``#``/``%`` comments, one
    ``u v`` pair a line, 0-based ids) into (n, edges): n = largest id + 1,
    pairs as sorted unique undirected edges.  ``native`` as
    :func:`load_dimacs_gr`; ``ValueError`` on a file without edges, a
    negative id or a malformed line (``OverflowError`` for an id beyond
    int32 on the Python path)."""
    pairs = _native_text_parse(
        path, native, lambda nl: nl.load_snap_pairs(os.fspath(path)), "SNAP"
    )
    if pairs is not None:
        if pairs.size == 0:
            raise ValueError(f"{path}: no edges found")
        return int(pairs.max()) + 1, _canonical_undirected(pairs)
    us: List[np.ndarray] = []
    chunk: List[int] = []
    with _open_text(path) as f:
        for line in f:
            if line.startswith(("#", "%")) or not line.strip():
                continue
            u, v, *_ = line.split()
            chunk.append(int(u))
            chunk.append(int(v))
            if len(chunk) >= 1 << 21:
                us.append(np.asarray(chunk, dtype=np.int32))
                chunk = []
    us.append(np.asarray(chunk, dtype=np.int32))
    flat = np.concatenate(us)
    if flat.size == 0:
        raise ValueError(f"{path}: no edges found")
    pairs = flat.reshape(-1, 2)
    if pairs.min() < 0:
        raise ValueError(f"{path}: negative vertex id")
    return int(pairs.max()) + 1, _canonical_undirected(pairs)


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
