"""Seeded graph and query generators (NumPy ``default_rng`` streams).

The same seed gives the same graph as the JAX package's generators, so a
fixture built here can be held against either package.
"""

from __future__ import annotations

from typing import List, Tuple

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
) -> Tuple[int, np.ndarray]:
    """Graph500-style R-MAT: n = 2^scale vertices, m = edge_factor * n
    undirected records (duplicates and self-loops kept, as the reference
    loader keeps them).  Level-by-level quadrant sampling, then a random
    vertex permutation; the NumPy stream of the JAX package's generator,
    so one seed gives one graph in both packages."""
    n = 1 << scale
    m = edge_factor * n
    d = 1.0 - a - b - c
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
