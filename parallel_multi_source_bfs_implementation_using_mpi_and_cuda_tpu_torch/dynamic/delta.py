"""Versioned edge-delta log against a frozen base graph.

The port's copy of the JAX package's dynamic/delta.py: the digest chain,
the delta file format and the patched CSRs are the JAX package's, byte for
byte; the rebuild runs in the native loader unless ``native=False``.

The log's domain is the *canonical undirected edge set* of the base
graph — ``u < v`` pairs, self-loops dropped, duplicates collapsed —
exactly the ``io._canonical_undirected`` semantics the text converters
and the 2D partition's global-coordinate contract already use.  That
makes mutation algebra trivial and total: inserting an edge that is
already present and deleting one that is absent are both no-ops, an
insert and a delete of the same pair in one batch nets to *present*
(delete-then-insert order), and ``apply()`` is a pure set fold, so the
patched CSR is bit-identical to rebuilding the CSR from scratch on the
mutated edge list (the fuzz-parity contract, tests/test_dynamic.py).

Identity is content-derived: version 0 carries the base graph's digest
and every appended batch chains ``sha256(prev | inserts | deletes)``
down to the 12-hex convention of ``serve.registry.content_hash``, so a
``(base_digest, version)`` pair — or the chained digest alone — names
one exact edge set.  Two logs that applied the same batches in the same
order agree on every digest; any divergence (reordered, dropped, or
altered batch) splits the chain at exactly the first bad version.

Binary delta files (``gen_cli.py --deltas``, bench config 8) follow the
reference loaders' fail-before-allocate posture: counts are validated
against the actual file size before any array is allocated, so a
bit-flipped header can never turn a 1 KiB file into a giant allocation.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..models.csr import CSRGraph

DELTA_MAGIC = b"MSBD"
DELTA_HEADER = struct.Struct("<4siq")  # magic, int32 n, int64 num_batches
BATCH_HEADER = struct.Struct("<qq")  # int64 n_inserts, int64 n_deletes


def canonical_edge_keys(edges: np.ndarray) -> np.ndarray:
    """(m, 2) int array -> sorted unique int64 keys ``lo << 32 | hi``
    with self-loops dropped (a self-loop can never change a BFS
    distance, main.cu:30-32; dropping them here keeps the set algebra
    closed under the same rule the loaders apply)."""
    edges = np.asarray(edges)
    if edges.size == 0:
        return np.zeros(0, dtype=np.int64)
    edges = edges.reshape(-1, 2)
    lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
    hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
    keep = lo != hi
    return np.unique((lo[keep] << 32) | hi[keep])


def keys_to_pairs(keys: np.ndarray) -> np.ndarray:
    """Sorted int64 keys -> (M, 2) int32 ``u < v`` edge records, the
    deterministic edge order every ``apply()`` rebuild shares."""
    keys = np.asarray(keys, dtype=np.int64)
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1).astype(np.int32)


def _validate_endpoints(pairs: np.ndarray, n: int, label: str) -> None:
    if pairs.size and (pairs.min() < 0 or pairs.max() >= n):
        raise ValueError(f"{label} endpoint out of range [0, {n})")


def _chain_digest(prev: str, insert_keys: np.ndarray, delete_keys: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(prev.encode())
    h.update(b"|ins|")
    h.update(np.ascontiguousarray(insert_keys).tobytes())
    h.update(b"|del|")
    h.update(np.ascontiguousarray(delete_keys).tobytes())
    return h.hexdigest()[:12]


@dataclasses.dataclass(frozen=True)
class DeltaBatch:
    """One canonicalized mutation batch: sorted unique ``u < v`` pairs,
    inserts and deletes disjoint (same-pair overlap nets to insert)."""

    inserts: np.ndarray  # (A, 2) int32, u < v, sorted
    deletes: np.ndarray  # (B, 2) int32, u < v, sorted
    version: int  # version this batch PRODUCES (>= 1)
    digest: str  # chained 12-hex content digest at this version

    @property
    def insert_keys(self) -> np.ndarray:
        return canonical_edge_keys(self.inserts)

    @property
    def delete_keys(self) -> np.ndarray:
        return canonical_edge_keys(self.deletes)


def canonicalize_batch(
    inserts, deletes, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Raw (maybe ragged / duplicated / self-looped) insert+delete pair
    lists -> disjoint canonical key arrays.  A pair named in both lists
    ends up PRESENT after the batch (delete-then-insert order), so the
    overlap is dropped from the delete side."""
    ins = np.asarray(inserts, dtype=np.int64).reshape(-1, 2)
    dels = np.asarray(deletes, dtype=np.int64).reshape(-1, 2)
    _validate_endpoints(ins, n, "insert")
    _validate_endpoints(dels, n, "delete")
    ins_keys = canonical_edge_keys(ins)
    del_keys = canonical_edge_keys(dels)
    del_keys = np.setdiff1d(del_keys, ins_keys, assume_unique=True)
    return ins_keys, del_keys


class DeltaLog:
    """Versioned mutation log for one base graph.

    Version 0 is the registered base; ``append()`` produces version
    ``v+1`` with a chained content digest.  ``apply(v)`` folds the set
    algebra and rebuilds the dedup CSR; ``net_delta(v_from, v_to)``
    composes any span of batches into ONE minimal insert/delete pair —
    what the repair path feeds on when a cached plane is several
    versions stale.
    """

    def __init__(self, n: int, base_keys: np.ndarray, base_digest: str):
        self.n = int(n)
        self.base_digest = str(base_digest)
        self._base_keys = np.asarray(base_keys, dtype=np.int64)
        # Weighted bases (weighted/): canonical key -> cost, parallel
        # sorted arrays.  None = weightless base; apply() then rebuilds
        # weightless CSRs exactly as before.
        self._weight_keys: Optional[np.ndarray] = None
        self._weight_vals: Optional[np.ndarray] = None
        self._batches: List[DeltaBatch] = []
        # Edge-key snapshot per version: repair and apply() both need
        # arbitrary-version access, and the snapshots share memory with
        # the fold (setdiff/union return fresh arrays only for the
        # touched span).  Localized deltas keep these cheap; a registry
        # reload drops the whole log anyway.
        self._keys: List[np.ndarray] = [self._base_keys]

    @staticmethod
    def from_graph(graph: CSRGraph, base_digest: str,
                   native: bool = True) -> "DeltaLog":
        """Open a log over a loaded CSR: the base key set is the CSR's
        canonical undirected edge set (directed slots collapsed).  A
        weighted base additionally snapshots the canonical key -> cost
        map (parallel edges at min cost, the dedup contract), so
        ``apply()`` rebuilds weighted CSRs: kept edges keep their cost,
        inserted edges default to cost 1 — a mutation batch names
        pairs, not costs, and 1 is the weightless-compatible floor."""
        degrees = np.diff(graph.row_offsets)
        u_all = np.repeat(np.arange(graph.n, dtype=np.int64), degrees)
        v_all = np.asarray(graph.col_indices, dtype=np.int64)
        keys = canonical_edge_keys(np.stack([u_all, v_all], axis=1))
        log = DeltaLog(graph.n, keys, base_digest)
        if getattr(graph, "has_weights", False):
            du, dv, dw, _ = graph.deduped_weighted(native)
            half = du < dv  # each undirected record once
            log._weight_keys = (
                du[half].astype(np.int64) << 32
            ) | dv[half].astype(np.int64)
            log._weight_vals = dw[half].astype(np.int32)
        return log

    @property
    def weighted(self) -> bool:
        return self._weight_keys is not None

    def _weights_for(self, keys: np.ndarray) -> np.ndarray:
        """Costs for a canonical key set: base map hits keep their
        cost, misses (edges inserted after the base) cost 1."""
        out = np.ones(keys.size, dtype=np.int32)
        wk, wv = self._weight_keys, self._weight_vals
        if wk is not None and wk.size and keys.size:
            idx = np.searchsorted(wk, keys)
            idx = np.minimum(idx, wk.size - 1)
            hit = wk[idx] == keys
            out[hit] = wv[idx[hit]]
        return out

    @property
    def version(self) -> int:
        return len(self._batches)

    @property
    def batches(self) -> Sequence[DeltaBatch]:
        return tuple(self._batches)

    def digest(self, version: Optional[int] = None) -> str:
        v = self.version if version is None else int(version)
        if not 0 <= v <= self.version:
            raise ValueError(f"version {v} outside [0, {self.version}]")
        return self.base_digest if v == 0 else self._batches[v - 1].digest

    def keys_at(self, version: Optional[int] = None) -> np.ndarray:
        v = self.version if version is None else int(version)
        if not 0 <= v <= self.version:
            raise ValueError(f"version {v} outside [0, {self.version}]")
        return self._keys[v]

    def append(self, inserts, deletes) -> DeltaBatch:
        """Canonicalize one mutation batch and chain it: deletes drop,
        inserts add (set semantics — missing deletes and present
        inserts are no-ops by construction)."""
        ins_keys, del_keys = canonicalize_batch(inserts, deletes, self.n)
        prev = self._keys[-1]
        keys = np.union1d(
            np.setdiff1d(prev, del_keys, assume_unique=True), ins_keys
        )
        batch = DeltaBatch(
            inserts=keys_to_pairs(ins_keys),
            deletes=keys_to_pairs(del_keys),
            version=self.version + 1,
            digest=_chain_digest(self.digest(), ins_keys, del_keys),
        )
        self._batches.append(batch)
        self._keys.append(keys)
        return batch

    def apply(
        self, version: Optional[int] = None, native: bool = True
    ) -> Tuple[CSRGraph, Tuple[str, int]]:
        """The patched dedup CSR at ``version`` (default: latest), plus
        its content-derived ``(base_digest, version)`` identity.  The
        rebuild goes through ``CSRGraph.from_edges`` on the canonical
        sorted pair list, so it is bit-identical to building from
        scratch on the mutated edge list, natively or (``native=False``)
        with the NumPy build."""
        v = self.version if version is None else int(version)
        keys = self.keys_at(v)
        weights = self._weights_for(keys) if self.weighted else None
        graph = CSRGraph.from_edges(
            self.n, keys_to_pairs(keys), native=native, weights=weights
        )
        return graph, (self.base_digest, v)

    def net_delta(
        self, v_from: int, v_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Compose batches ``v_from+1 .. v_to`` into one minimal delta:
        (inserts, deletes) (each (M, 2) int32) such that applying it to
        the version-``v_from`` edge set yields version ``v_to``.  An
        edge inserted then deleted across the span cancels entirely —
        repair cones never pay for churn that nets out."""
        old = self.keys_at(v_from)
        new = self.keys_at(self.version if v_to is None else v_to)
        inserts = np.setdiff1d(new, old, assume_unique=True)
        deletes = np.setdiff1d(old, new, assume_unique=True)
        return keys_to_pairs(inserts), keys_to_pairs(deletes)


def save_delta_bin(
    path: str | os.PathLike,
    n: int,
    batches: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> None:
    """Write the binary delta format: header (magic, n, num_batches),
    then per batch (int64 counts, int32 insert pairs, int32 delete
    pairs).  ``batches`` is a sequence of (inserts, deletes) pair
    arrays; they are canonicalized on write so every consumer of the
    file sees the same disjoint sorted batches."""
    with open(path, "wb") as f:
        f.write(DELTA_HEADER.pack(DELTA_MAGIC, int(n), len(batches)))
        for inserts, deletes in batches:
            ins_keys, del_keys = canonicalize_batch(inserts, deletes, n)
            ins = keys_to_pairs(ins_keys)
            dels = keys_to_pairs(del_keys)
            f.write(BATCH_HEADER.pack(ins.shape[0], dels.shape[0]))
            np.ascontiguousarray(ins).tofile(f)
            np.ascontiguousarray(dels).tofile(f)


def load_delta_bin(
    path: str | os.PathLike,
) -> Tuple[int, List[Tuple[np.ndarray, np.ndarray]]]:
    """Load a binary delta file -> (n, [(inserts, deletes), ...]).

    Counts are validated against the actual file size BEFORE any
    allocation (the load_graph_bin posture): a corrupt header fails
    loudly instead of attempting a giant ``np.fromfile``.
    """
    with open(path, "rb") as f:
        header = f.read(DELTA_HEADER.size)
        if len(header) < DELTA_HEADER.size:
            raise IOError(f"truncated delta header in {path}")
        magic, n, num_batches = DELTA_HEADER.unpack(header)
        if magic != DELTA_MAGIC:
            raise IOError(f"bad delta magic in {path}: {magic!r}")
        if n < 0 or num_batches < 0:
            raise IOError(
                f"corrupt delta header in {path}: n={n}, batches={num_batches}"
            )
        remaining = os.fstat(f.fileno()).st_size - DELTA_HEADER.size
        batches: List[Tuple[np.ndarray, np.ndarray]] = []
        for i in range(num_batches):
            head = f.read(BATCH_HEADER.size)
            if len(head) < BATCH_HEADER.size:
                raise IOError(f"truncated delta batch header in {path}")
            remaining -= BATCH_HEADER.size
            a, b = BATCH_HEADER.unpack(head)
            if a < 0 or b < 0 or remaining < 8 * (a + b):
                raise IOError(
                    f"corrupt delta batch {i} in {path}: claims "
                    f"{a}+{b} pairs, {remaining} bytes left"
                )
            ins = np.fromfile(f, dtype=np.int32, count=2 * a).reshape(a, 2)
            dels = np.fromfile(f, dtype=np.int32, count=2 * b).reshape(b, 2)
            remaining -= 8 * (a + b)
            batches.append((ins, dels))
    return n, batches
