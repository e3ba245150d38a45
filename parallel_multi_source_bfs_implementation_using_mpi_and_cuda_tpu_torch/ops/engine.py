"""The engine surface every query engine shares (``f_values``, ``best``,
``query_stats``, ``compile``), the engine lattice that routes negotiate
on (capability tokens), the generic distance-matrix engine, the host-side
source band, and the frontier-density estimate the direction switches
route on."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.timing import record_dispatch
from .bfs import (
    distance_carry_init,
    distance_chunk,
    host_chunked_loop,
    stats_from_distances,
    validate_level_chunk,
)
from .objective import f_of_u, select_best


def frontier_activity(frontier: torch.Tensor, edge_counts: torch.Tensor):
    """(active, cnt, edges) frontier-density estimate of an (n, lanes)
    plane (a nonzero row is a frontier vertex) against the per-vertex
    dedup out-degree: the (n,) bool active mask, the int32 active-row
    count and the int32 outgoing-edge total of the active rows, all on
    the frontier's device (no host read)."""
    active = (frontier != 0).any(dim=1)
    cnt = active.sum(dtype=torch.int32)
    edges = torch.where(active, edge_counts, 0).sum(dtype=torch.int32)
    return active, cnt, edges


def source_band(queries, n: int):
    """Initial frontier band ``[lo, hi)`` from (K, S) host queries — the
    active-row estimate the stencil window sizes its first chunk from;
    ``[0, 0]`` when no source is in range."""
    q = np.asarray(queries)
    valid = (q >= 0) & (q < n)
    if not valid.any():
        return [0, 0]
    vs = q[valid]
    return [int(vs.min()), int(vs.max()) + 1]


class QueryEngineBase:
    """Selection/compile surface over any ``f_values`` implementation.

    ``CAPABILITIES`` declares what an engine class can structurally do,
    as capability tokens that :func:`negotiate_engine` keys on: the
    lattice's ``axis:value`` tokens, and ``banded``, ``streamed``,
    ``weighted``, ``windowed``, ``mesh2d`` (the JAX package's set)."""

    CAPABILITIES: frozenset = frozenset()

    def f_values(self, queries) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def best(self, queries) -> Tuple[int, int]:
        """Run all groups; return (minF, minK) — reference main.cu:309-397."""
        f = self.f_values(queries)
        min_f, min_k = torch.stack(select_best(f, f >= 0)).tolist()
        record_dispatch()
        return min_f, min_k

    def compile(
        self, queries_shape: Tuple[int, int], warm_stats: bool = False,
        warm_levels: bool = False,
    ) -> None:
        """Warm everything a (K, S) batch runs so the cost lands in the
        preprocessing span: one run on an all-padding batch, and with
        ``warm_stats`` / ``warm_levels`` the per-query stats and the
        stepped per-level trace (on engines that have one) too."""
        dummy = np.full(queries_shape, -1, dtype=np.int32)
        self.best(dummy)
        self._warm_stats(dummy, warm_stats, warm_levels)

    def _warm_stats(self, dummy, warm_stats: bool, warm_levels: bool) -> None:
        if warm_stats and dummy.shape[0]:
            self.query_stats(dummy)
        if warm_levels and dummy.shape[0] and callable(getattr(self, "level_stats", None)):
            self.level_stats(dummy)

    def query_stats(self, queries):
        """Per-query (levels, reached, F) numpy arrays, or None."""
        return None


# The engine lattice (the JAX package's ops/engine.py, letter for letter
# in its messages): an engine is a configuration on four axes, a route
# resolves a backend name and its knobs to capability tokens
# (:func:`resolve_axes`), and :func:`negotiate_engine` picks the first
# candidate class that declares them, or fails naming what is missing.
AXES = {
    "plane": ("bit", "byte", "word"),
    "residency": ("hbm", "streamed"),
    "partition": ("single", "1d", "mesh2d"),
    "kernel": ("xla", "pallas", "mxu"),
}

#: backend name -> the axis values that backend pins (unset axes keep
#: the lattice defaults: bit planes, HBM residency, XLA kernel).
BACKEND_AXES = {
    "bitbell": {"plane": "bit"},
    "bell": {"plane": "word"},
    "lowk": {"plane": "byte"},
    "mxu": {"plane": "bit", "kernel": "mxu"},
    "streamed": {"plane": "bit", "residency": "streamed"},
    "stencil": {"plane": "bit"},
    "packed": {"plane": "word"},
    "ppush": {"plane": "word"},
    "push": {"plane": "word"},
    "dense": {"plane": "word"},
    "vmap": {"plane": "word"},
    "pallas": {"plane": "word", "kernel": "pallas"},
}

#: extra (non-axis) tokens a backend demands beyond its axis values.
BACKEND_EXTRAS = {
    "stencil": frozenset({"banded"}),
}


class NegotiationError(ValueError):
    """A knob combination that cannot negotiate (a ValueError, so every
    ``except ValueError`` route keeps working)."""


def axis_tokens(axes) -> frozenset:
    """``axes`` dict -> the ``axis:value`` capability tokens it demands."""
    return frozenset(f"{axis}:{value}" for axis, value in axes.items())


# Axis-value pairs that no engine composes: checked up front so the
# failure names the pair, not a missing token of whichever candidate came
# first.
_INCOMPATIBLE = (
    ("plane:byte", "kernel:mxu"),
    ("plane:byte", "async"),
    ("kernel:mxu", "residency:streamed"),
    ("kernel:mxu", "async"),
)


def resolve_axes(
    backend: str,
    partition: str = "single",
    residency: Optional[str] = None,
    plane: Optional[str] = None,
    kernel: Optional[str] = None,
    async_levels: int = 1,
    weighted: bool = False,
):
    """Map a backend name and routing knobs to the lattice: ``(axes,
    required)``, the resolved axes and the capability tokens a route
    demands.  ``residency``/``plane``/``kernel`` override the backend's
    value for their axis.  Raises :class:`NegotiationError` for an unknown
    backend or axis value, or a pair no engine composes."""
    if backend not in BACKEND_AXES:
        raise NegotiationError(
            f"unknown backend {backend!r}: not on the engine lattice "
            f"(known: {', '.join(sorted(BACKEND_AXES))})"
        )
    if partition not in AXES["partition"]:
        raise NegotiationError(
            f"unknown partition {partition!r} (axis values: "
            f"{', '.join(AXES['partition'])})"
        )
    for axis, value in (
        ("residency", residency), ("plane", plane), ("kernel", kernel)
    ):
        if value is not None and value not in AXES[axis]:
            raise NegotiationError(
                f"unknown {axis} {value!r} (axis values: "
                f"{', '.join(AXES[axis])})"
            )
    axes = {
        "plane": "bit",
        "residency": "hbm",
        "partition": partition,
        "kernel": "xla",
    }
    axes.update(BACKEND_AXES[backend])
    if residency is not None:
        axes["residency"] = residency
    if plane is not None:
        axes["plane"] = plane
    if kernel is not None:
        axes["kernel"] = kernel
    required = set(axis_tokens(axes))
    required |= BACKEND_EXTRAS.get(backend, frozenset())
    if axes["partition"] == "mesh2d":
        # Mesh routes demand survivability (the supervisor's
        # degrade-to-survivors path).
        required.add("reshard")
    if async_levels > 1:
        required.add("async")
    if weighted:
        required.add("weighted")
    bad = [
        (a, b)
        for a, b in _INCOMPATIBLE
        if a in required and b in required
    ]
    if bad:
        raise NegotiationError(
            "no engine composes "
            + " or ".join(f"{a} with {b}" for a, b in bad)
            + f" (backend={backend}, partition={axes['partition']})"
        )
    return axes, frozenset(required)


def engine_label(axes, async_levels: int = 1, extras=()) -> str:
    """The canonical engine label of resolved axes ("bitbell", "lowk",
    "mesh2d+streamed", ...), derived from the tokens alone."""
    if axes.get("partition") == "mesh2d":
        label = "mesh2d"
        if axes.get("plane") == "byte":
            label += "+byte"
        if axes.get("kernel") == "mxu":
            label += "+mxu"
        if axes.get("residency") == "streamed":
            label += "+streamed"
        if async_levels > 1:
            label += f"+async{async_levels}"
        return label
    if axes.get("kernel") == "mxu":
        return "mxu"
    if axes.get("kernel") == "pallas":
        return "pallas"
    if "banded" in extras:
        return "stencil"
    if axes.get("residency") == "streamed":
        return "streamed"
    if axes.get("plane") == "byte":
        return "lowk"
    if axes.get("plane") == "word":
        return "dense"
    return "bitbell"


def negotiate_engine(required, candidates):
    """``(label, engine)`` of the first ``(label, engine_cls, factory)``
    candidate whose class declares every ``required`` token; only the
    winner's factory runs.  No winner raises :class:`NegotiationError`
    naming each candidate's missing tokens."""
    required = frozenset(required)
    misses = []
    for label, engine_cls, factory in candidates:
        have = frozenset(getattr(engine_cls, "CAPABILITIES", ()))
        missing = required - have
        if not missing:
            return label, factory()
        misses.append(f"{label} lacks {{{', '.join(sorted(missing))}}}")
    raise NegotiationError(
        f"no engine provides {{{', '.join(sorted(required))}}}: "
        + "; ".join(misses)
    )


class Engine(QueryEngineBase):
    """Runs query groups against a device-resident graph with the
    distance-matrix level loop (the JAX package's generic ``Engine``).
    The graph container supplies its level step, as JAX's ``graph_expand``
    dispatches to ``graph.expand_frontier``: ``level_step(plain)`` gives
    a gated one-level step on a :class:`.bfs.DistCarry` — DeviceCSR the
    CSR pull (K9), DenseGraph the matmul, EllGraph the ELL level (K8).

    ``query_chunk``: queries per batch of the loop (None: all K at once);
    each batch holds a (chunk, n_pad) int32 distance matrix.
    ``level_chunk`` bounds the levels between host syncs (None: one run
    to convergence).  ``plain`` runs the kernel's plain torch version
    (the reference, on any device)."""

    # Lattice axes: the generic word-plane host; both kernel values, since
    # the graph container picks the level step (CSR pull, matmul, ELL).
    CAPABILITIES = frozenset(
        {
            "plane:word",
            "residency:hbm",
            "partition:single",
            "kernel:xla",
            "kernel:pallas",
        }
    )

    def __init__(
        self,
        graph,
        max_levels: Optional[int] = None,
        query_chunk: Optional[int] = None,
        level_chunk: Optional[int] = None,
        plain: bool = False,
    ):
        self.graph = graph
        self.device = graph.device
        self.max_levels = max_levels
        self.query_chunk = query_chunk
        self.level_chunk = validate_level_chunk(level_chunk)
        self.plain = bool(plain)
        self._step = graph.level_step(self.plain)

    def _chunk_grid(self, queries) -> Tuple[np.ndarray, int]:
        """Pad K to the chunk multiple with -1 rows and reshape to
        (C, chunk, S), on the host."""
        queries = np.asarray(queries, dtype=np.int32)
        k, s = queries.shape
        chunk = self.query_chunk or max(k, 1)
        pad = (-k) % chunk
        if pad:
            queries = np.concatenate(
                [queries, np.full((pad, s), -1, dtype=np.int32)], axis=0
            )
        return queries.reshape((k + pad) // chunk, chunk, s), k

    def _dist_batch(self, queries_batch) -> torch.Tensor:
        """Final (J, n) distances of one (J, S) query batch."""
        carry = distance_carry_init(
            self.graph.n, queries_batch, self.graph.n_pad, self.device
        )
        if self.level_chunk:
            host_chunked_loop(
                carry,
                lambda c: distance_chunk(
                    c, self._step, self.level_chunk, self.max_levels
                ),
                self.max_levels,
            )
        else:
            distance_chunk(carry, self._step, None, self.max_levels)
        return carry.dist

    def f_values(self, queries) -> torch.Tensor:
        """(K, S) int32 -1-padded queries -> (K,) int64 F values."""
        grid, k = self._chunk_grid(queries)
        if grid.shape[0] == 0:  # K = 0
            return torch.zeros(0, dtype=torch.int64, device=self.device)
        out = torch.cat([f_of_u(self._dist_batch(row)) for row in grid])
        return out[:k]

    def query_stats(self, queries):
        """Per-query (levels, reached, F) numpy arrays."""
        grid, k = self._chunk_grid(queries)
        if grid.shape[0] == 0:  # K = 0
            z = np.zeros(0, dtype=np.int64)
            return z.astype(np.int32), z.astype(np.int32), z
        rows = [stats_from_distances(self._dist_batch(r)) for r in grid]
        return tuple(
            torch.cat(col).cpu().numpy()[:k] for col in zip(*rows)
        )

    def compile(self, queries_shape, warm_stats: bool = False, warm_levels: bool = False) -> None:
        """Build and load the kernel, then run one batch from one source,
        so module loads and first-call allocations land in the
        preprocessing span (the stats path too with ``warm_stats``)."""
        if self.device.type == "cuda" and not self.plain:
            from ..runtime import kernels

            kernels.library()
        dummy = np.full(queries_shape, -1, dtype=np.int32)
        if self.graph.n and dummy.size:
            dummy[0, 0] = 0
        self.best(dummy)
        self._warm_stats(dummy, warm_stats, warm_levels)
