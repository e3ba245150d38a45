"""Seeded graph and query generators (NumPy ``default_rng`` streams).

The same seed gives the same graph as the JAX package's generators, so a
fixture built here can be held against either package.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def grid_edges(rows: int, cols: int) -> Tuple[int, np.ndarray]:
    """4-neighbor grid: n = rows*cols, high diameter, residual-free as a
    stencil (offsets +-1, +-cols)."""
    idx = np.arange(rows * cols, dtype=np.int32).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down], axis=0).astype(np.int32)
    return rows * cols, edges


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    native: Optional[bool] = None,
) -> Tuple[int, np.ndarray]:
    """Graph500-style R-MAT: n = 2^scale vertices, m = edge_factor * n
    undirected records (duplicates and self-loops kept, as the reference
    loader keeps them).  Level-by-level quadrant sampling, then a random
    vertex permutation; the NumPy stream of the JAX package's generator,
    so one seed gives one graph in both packages.

    ``native`` (default: ``MSBFS_NATIVE_RMAT=1``) samples in the native
    runtime instead (runtime/loader.cpp ``msbfs_rmat_edges``): the same
    construction from splitmix64 streams, so one seed gives another graph
    than the NumPy stream, from the same distribution, and the same graph
    as the JAX package's native sampler at any thread count.  A native
    stream asked for is never replaced by the NumPy one: a runtime that
    cannot be built raises."""
    n = 1 << scale
    m = edge_factor * n
    d = 1.0 - a - b - c
    if native is None:
        from ..utils import knobs

        native = knobs.raw("MSBFS_NATIVE_RMAT") == "1"
    if native:
        from ..runtime import native_loader

        return n, native_loader.rmat_edges(scale, m, a, b, c, seed)
    rng = np.random.default_rng(seed)
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    p_u1 = c + d
    p_v1_given_u0 = b / (a + b)
    p_v1_given_u1 = d / (c + d)
    for _ in range(scale):
        u_bit = rng.random(m) < p_u1
        p_v1 = np.where(u_bit, p_v1_given_u1, p_v1_given_u0)
        v_bit = rng.random(m) < p_v1
        u = (u << 1) | u_bit
        v = (v << 1) | v_bit
    perm = rng.permutation(n).astype(np.int64)
    edges = np.stack([perm[u], perm[v]], axis=1)
    return n, edges.astype(np.int32)


def road_edges(
    rows: int,
    cols: int,
    seed: int = 0,
    keep: float = 0.55,
    diag: float = 0.06,
    shortcut_frac: float = 0.0005,
    shortcut_reach: int = 0,
) -> Tuple[int, np.ndarray]:
    """Synthetic road network calibrated to the DIMACS USA-road-d family:
    a 4-neighbor grid with each edge kept with probability ``keep``,
    diagonal links with probability ``diag``, and ``shortcut_frac * n``
    medium-range links (highway segments) of at most ``shortcut_reach``
    (default side/8) grid steps per axis.  The defaults give mean degree
    ~2.44 (USA-road-d: 58.3M arcs / 23.9M nodes) and diameter
    Theta(rows + cols).  Returns (n, edges) in the reference loader's
    convention (one undirected record per row)."""
    rng = np.random.default_rng(seed)
    n = rows * cols
    idx = np.arange(n, dtype=np.int32).reshape(rows, cols)
    parts = []
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    parts.append(right[rng.random(len(right)) < keep])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    parts.append(down[rng.random(len(down)) < keep])
    dr = np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], axis=1)
    parts.append(dr[rng.random(len(dr)) < diag])
    dl = np.stack([idx[:-1, 1:].ravel(), idx[1:, :-1].ravel()], axis=1)
    parts.append(dl[rng.random(len(dl)) < diag])
    k = int(n * shortcut_frac)
    if k:
        reach = shortcut_reach or max(2, min(rows, cols) // 8)
        r0 = rng.integers(0, rows, size=k)
        c0 = rng.integers(0, cols, size=k)
        r1 = np.clip(r0 + rng.integers(-reach, reach + 1, size=k), 0, rows - 1)
        c1 = np.clip(c0 + rng.integers(-reach, reach + 1, size=k), 0, cols - 1)
        parts.append(
            np.stack([idx[r0, c0], idx[r1, c1]], axis=1).astype(np.int32)
        )
    edges = np.concatenate(parts, axis=0).astype(np.int32)
    return n, edges


def hub_tail_edges(
    tail: int = 2500, hub_fan: int = 100
) -> Tuple[int, np.ndarray]:
    """Adversarial degree profile: a ``tail``-vertex path (deep BFS) with
    one ``hub_fan``-degree hub grafted onto vertex 0, a high maximum
    degree on a high-diameter graph, which a route chosen by degree alone
    would misjudge.  Layout: path 0..tail-1, hub ``tail``, leaves
    ``tail+1..n-1``; int64 records, as the JAX package's."""
    n = tail + 1 + hub_fan
    path = np.stack([np.arange(tail - 1), np.arange(1, tail)], axis=1)
    hub = tail
    leaves = np.stack(
        [np.full(hub_fan, hub), np.arange(tail + 1, n)], axis=1
    )
    bridge = np.array([[0, hub]])
    return n, np.concatenate([path, bridge, leaves]).astype(np.int64)


def random_queries(
    n: int, k: int, max_group: int = 128, seed: int = 0
) -> List[np.ndarray]:
    """K ragged source groups with sizes in [1, max_group] (query format
    limits: K <= 255, group size <= 255)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        size = int(rng.integers(1, max_group + 1))
        out.append(rng.integers(0, n, size=size, dtype=np.int64).astype(np.int32))
    return out


def edge_costs(
    m: int,
    dist: str = "uniform",
    max_cost: int = 16,
    seed: int = 0,
    zipf_a: float = 1.6,
) -> np.ndarray:
    """(m,) int32 positive edge costs in [1, max_cost] for the weighted
    route, the JAX package's streams: ``uniform`` draws each cost uniformly
    (road-style travel costs), ``zipf`` a Zipf(``zipf_a``) clipped to
    ``max_cost`` (most links cheap, a few dear).  Same seed, same costs."""
    if m < 0:
        raise ValueError(f"m must be >= 0, got {m}")
    if max_cost < 1:
        raise ValueError(f"max_cost must be >= 1, got {max_cost}")
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        w = rng.integers(1, max_cost + 1, size=m, dtype=np.int64)
    elif dist == "zipf":
        w = np.minimum(rng.zipf(zipf_a, size=m), max_cost)
    else:
        raise ValueError(f"unknown cost distribution {dist!r}")
    return w.astype(np.int32)


def gnm_edges(n: int, m: int, seed: int = 0) -> Tuple[int, np.ndarray]:
    """Uniform G(n, m) multigraph (duplicates and self-loops possible);
    the JAX package's generator, the same edges for the same seed."""
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(m, 2), dtype=np.int64).astype(np.int32)
    return n, edges


def delta_batches(
    n: int,
    edges: np.ndarray,
    batches: int = 1,
    batch_size: int = 16,
    locality: float = 0.9,
    insert_frac: float = 0.5,
    seed: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Seeded edge-delta batches against (n, edges) for the dynamic graphs
    (``dynamic.delta``): each batch is (inserts, deletes) pair arrays,
    ``batch_size`` mutations split ``insert_frac``/rest.  The JAX
    package's generator: the same batches for the same seed.

    ``locality`` in [0, 1]: each batch draws every endpoint from one
    contiguous vertex-id window of ``max(8, round(n * (1 - locality)))``
    ids (1.0 is a street-closure-sized patch on a row-major grid, 0.0 is
    whole-graph churn).  Deletes are drawn from the live canonical edge
    set, inside the window; inserts are fresh window-local pairs."""
    from ..dynamic.delta import canonical_edge_keys, keys_to_pairs

    if not 0.0 <= locality <= 1.0:
        raise ValueError(f"locality must be in [0, 1], got {locality}")
    rng = np.random.default_rng(seed)
    live = canonical_edge_keys(np.asarray(edges))
    span = max(8, int(round(n * (1.0 - locality))))
    span = min(span, n)
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for _ in range(batches):
        lo = int(rng.integers(0, max(1, n - span + 1)))
        hi = lo + span
        n_ins = int(round(batch_size * insert_frac))
        n_del = batch_size - n_ins
        ins = rng.integers(lo, hi, size=(n_ins, 2), dtype=np.int64).astype(
            np.int32
        )
        pairs = keys_to_pairs(live)
        in_window = (pairs[:, 0] >= lo) & (pairs[:, 1] < hi)
        candidates = live[in_window]
        take = min(n_del, candidates.size)
        dels_keys = (
            rng.choice(candidates, size=take, replace=False)
            if take
            else np.zeros(0, dtype=np.int64)
        )
        dels = keys_to_pairs(np.sort(dels_keys))
        out.append((ins, dels))
        live = np.union1d(
            np.setdiff1d(live, dels_keys, assume_unique=False),
            canonical_edge_keys(ins),
        )
    return out


def component_labels(
    n: int, edges: np.ndarray, sample_cap: int = 1 << 24, seed: int = 0
) -> np.ndarray:
    """Per-vertex connected-component label (the least vertex id of the
    component): hooking and pointer jumping in NumPy.

    Beyond ``sample_cap`` records a uniform sample of ``sample_cap``
    records, drawn with replacement from ``default_rng(seed)``, is
    labelled instead.  A sample can only split components, never join
    two, so two vertices with one sampled label share a true component:
    the safe direction for :func:`ensure_giant_sources`."""
    label = np.arange(n, dtype=np.int64)
    e = np.asarray(edges, dtype=np.int64)
    e = e[(e[:, 0] >= 0) & (e[:, 0] < n) & (e[:, 1] >= 0) & (e[:, 1] < n)]
    if len(e) > sample_cap:
        # With replacement: a duplicate record does not change a label,
        # and a draw without would build an O(len(e)) permutation.
        rng = np.random.default_rng(seed)
        e = e[rng.integers(0, len(e), size=sample_cap)]
    u, v = e[:, 0], e[:, 1]
    while True:
        lu, lv = label[u], label[v]
        # Hook both endpoints to the smaller label; minimum.at resolves
        # colliding writes by their minimum.
        m = np.minimum(lu, lv)
        before = label.copy()
        np.minimum.at(label, u, m)
        np.minimum.at(label, v, m)
        # Jump to the fixed point (label[i] == label[label[i]]) before
        # the convergence test.
        while True:
            nxt = label[label]
            if np.array_equal(nxt, label):
                break
            label = nxt
        if np.array_equal(label, before):
            return label


def ensure_giant_sources(
    queries: List[np.ndarray],
    n: int,
    edges: np.ndarray,
    seed: int = 0,
) -> List[np.ndarray]:
    """Every query group with no source in the largest connected
    component gets its source 0 replaced by a seeded draw from it, so
    that no group reaches only dust and ``best()`` does not degenerate
    into a race to the smallest reach (F == 0).  The other sources stay
    as they were.  Returns modified copies; the input is not mutated."""
    labels = component_labels(n, edges, seed=seed)
    ids, counts = np.unique(labels, return_counts=True)
    giant_label = ids[np.argmax(counts)]
    giant = np.flatnonzero(labels == giant_label).astype(np.int32)
    rng = np.random.default_rng(seed)
    out = []
    for g in queries:
        g = np.asarray(g, dtype=np.int32)
        valid = g[(g >= 0) & (g < n)]
        if valid.size and np.any(labels[valid] == giant_label):
            out.append(g)
            continue
        fixed = g.copy()
        if fixed.size == 0:
            fixed = np.empty(1, dtype=np.int32)
        fixed[0] = giant[int(rng.integers(0, len(giant)))]
        out.append(fixed)
    return out
