"""Query-sharded execution over a ('q', 'v') mesh, the graph replicated.

The JAX package's parallel/distributed.py, the reference's MPI phase
structure (main.cu:242-397) on a mesh of devices:

* graph broadcast (main.cu:242-255)  -> one layout per distinct device;
* round-robin assignment (303-307)   -> the cyclic grid, row r on
                                        q-shard r (:func:`.scheduler.shard_queries`);
* per-rank BFS loop (312-322)        -> the single-device engine's level
                                        loop on each q-shard's device;
* Gather/Gatherv of (q, F) (324-368) -> the fixed-shape (K,) max merge
                                        (:func:`.scheduler.merge_local_f`);
* rank-0 argmin (379-397)            -> the selection on the merged vector.

One controller drives every shard, in lockstep with the SPMD program:
each chunk enqueues every shard's levels, then one stacked read of the
shards' controls decides whether another chunk runs (the JAX ``pmax``
of the updated flags), never a read per shard.  The bitbell backend runs
the port's BitBellEngine machinery on each q-shard — K4 ``batch_start``,
K3 ``push_or`` and K1 ``forest_or`` gated by the direction switch, K2
``level_apply`` — and the ``csr`` backend the distance loop over K9
``csr_pull`` (ops/engine.py ``Engine`` over a DeviceCSR).  A mesh's 'v'
axis replicates the work in JAX; here each q-shard runs on the device of
its first 'v' entry.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..models.csr import CSRGraph
from ..ops.bfs import INT32_MAX, validate_level_chunk
from ..ops.bitbell import WORD_BITS, bit_level_chunk
from ..ops.engine import QueryEngineBase
from ..utils.timing import record_dispatch
from .collectives import on_device, to_device
from .mesh import QUERY_AXIS, make_mesh
from .scheduler import merge_local_f, shard_queries


def pad_qblock(qblock: np.ndarray):
    """Right-pad a q-shard's (J, S) queries to a multiple of 32 rows with
    -1 (semantics-preserving, main.cu:49).  Returns (queries, j)."""
    j, s = qblock.shape
    pad = (-j) % WORD_BITS
    if pad:
        qblock = np.concatenate([qblock, np.full((pad, s), -1, dtype=qblock.dtype)])
    return np.ascontiguousarray(qblock, dtype=np.int32), j


def query_devices(mesh) -> List[torch.device]:
    """The device each q-shard runs on: its first 'v' entry's."""
    return [mesh.devices[r, 0] for r in range(mesh.shape[QUERY_AXIS])]


def stacked_read(parts: List[torch.Tensor]) -> np.ndarray:
    """One host read (counted) of small per-shard tensors: each goes to
    the first one's device, the stack is read once."""
    dev = parts[0].device
    out = torch.stack([to_device(p, dev) for p in parts]).cpu().numpy()
    record_dispatch()
    return out


def stacked_read_ragged(parts: List[torch.Tensor]):
    """One host read (counted) of 1-d tensors of any lengths: concatenated
    on the first one's device, read once, split back."""
    dev = parts[0].device
    sizes = [int(p.numel()) for p in parts]
    flat = torch.cat([to_device(p.reshape(-1), dev) for p in parts]).cpu().numpy()
    record_dispatch()
    return np.split(flat, np.cumsum(sizes)[:-1])


def stepped_level_stats(init, step, finish, k, max_levels, warmed: bool,
                        running: Callable[[object], bool]):
    """The shared per-level trace loop of the mesh engines (the JAX
    package's ``stepped_level_stats``, ``MSBFS_STATS=2`` at -gn > 1): one
    level a step, each timed with its merge, the BitBellEngine.level_stats
    contract — (levels, reached, f, level_counts, level_seconds), row d of
    ``level_counts`` the vertices found at distance d per query (row 0 the
    sources).

    ``init()`` -> carry; ``step(carry)`` -> the carry advanced one level;
    ``finish(carry)`` -> merged (f, levels, reached) (k_pad,) tensors;
    ``running(carry)`` -> whether some shard's last level found anything
    (one read; the JAX loop's ``carry[6].any()``).  ``warmed`` False runs
    one untimed init, step and finish first, as JAX's compile pass."""
    if not warmed:
        finish(step(init()))
    t0 = time.perf_counter()
    carry = init()
    _, _, reached0 = finish(carry)
    reached_prev = reached0[:k].cpu().numpy().astype(np.int64)
    record_dispatch()
    level_seconds = [time.perf_counter() - t0]
    level_counts = [reached_prev.copy()]
    while running(carry):
        if max_levels is not None and len(level_counts) > max_levels:
            break
        t0 = time.perf_counter()
        carry = step(carry)
        _, _, reached_m = finish(carry)
        reached = reached_m[:k].cpu().numpy().astype(np.int64)
        record_dispatch()
        level_seconds.append(time.perf_counter() - t0)
        level_counts.append(reached - reached_prev)
        reached_prev = reached
    f, levels, reached_m = finish(carry)
    record_dispatch()
    return (
        levels[:k].cpu().numpy().astype(np.int32),
        reached_m[:k].cpu().numpy().astype(np.int32),
        f[:k].cpu().numpy(),
        np.stack(level_counts),
        np.asarray(level_seconds),
    )


class DistributedEngine(QueryEngineBase):
    """Query-sharded execution over a mesh, the graph replicated on every
    device (the reference's full-graph-per-rank model).

    ``backend``: ``"bitbell"`` (default) runs the bit-plane forest engine
    on each q-shard's slice; ``"csr"`` the distance loop over the CSR pull
    (``query_chunk`` queries a batch).  ``level_chunk`` (bitbell): levels between the stacked reads
    (None runs each shard to convergence first).  ``native`` builds the
    layouts in the native runtime."""

    CAPABILITIES = frozenset(
        {
            "query_sharded",
            "reshard",
            "plane:bit",
            "residency:hbm",
            "partition:1d",
            "kernel:xla",
        }
    )

    def __init__(
        self,
        mesh,
        graph: CSRGraph,
        max_levels: Optional[int] = None,
        query_chunk: Optional[int] = None,
        backend: str = "bitbell",
        level_chunk: Optional[int] = None,
        native: bool = True,
    ):
        if not isinstance(graph, CSRGraph):
            raise ValueError("DistributedEngine builds its own layouts; pass the host CSRGraph")
        self.mesh = mesh
        self.w = mesh.shape[QUERY_AXIS]
        self._host_graph = graph
        self._qdev = query_devices(mesh)
        self.native = bool(native)
        if backend == "bitbell":
            if query_chunk is not None:
                # The knob exists only on the per-query CSR path.
                raise ValueError("query_chunk requires backend='csr'")
            from ..models.bell import BellGraph
            from ..ops.bitbell import BitBellEngine

            # One layout and one engine per distinct device, shared by the
            # q-shards there (their launches are ordered on its stream).
            self._engines = {}
            for dev in dict.fromkeys(self._qdev):
                with on_device(dev):
                    self._engines[dev] = BitBellEngine(
                        BellGraph.from_host(graph, dev, native=native),
                        max_levels=max_levels, megachunk=1,
                    )
            self.sparse_budget = next(iter(self._engines.values())).sparse_budget
        elif backend == "csr":
            from ..ops.engine import Engine

            self._engines = {}
            for dev in dict.fromkeys(self._qdev):
                with on_device(dev):
                    self._engines[dev] = Engine(graph.to_device(dev), max_levels=max_levels)
        else:
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        self.query_chunk = query_chunk
        if level_chunk is not None and backend != "bitbell":
            raise ValueError("level_chunk requires backend='bitbell'")
        self.level_chunk = validate_level_chunk(level_chunk)
        self._level_warm_shapes = set()
        if backend != "bitbell":
            # The stepped trace drives the bitbell carry; callers probe
            # support with callable(getattr(engine, "level_stats", None)).
            self.level_stats = None

    def without_ranks(self, failed_ranks) -> "DistributedEngine":
        """Rebuild this engine on the mesh's surviving entries (a lost
        device, runtime.supervisor recovery).  The lost ranks' queries land
        on survivors through the cyclic layout over the smaller mesh, so
        the merged (F, argmin) equal the fault-free run's: a query's F
        never depends on which rank computed it.  Raises DeviceError when
        no entry survives."""
        from ..runtime.supervisor import DeviceError

        failed = {int(r) for r in failed_ranks}
        survivors = [d for r, d in enumerate(self.mesh.flat_devices()) if r not in failed]
        if not survivors:
            raise DeviceError(
                f"no surviving devices (failed ranks {sorted(failed)})",
                failed_ranks=failed,
            )
        mesh = make_mesh(num_query_shards=len(survivors), devices=survivors)
        kwargs = dict(max_levels=self.max_levels, backend=self.backend,
                      level_chunk=self.level_chunk, native=self.native)
        if self.backend == "csr":
            kwargs.update(query_chunk=self.query_chunk)
        return DistributedEngine(mesh, self._host_graph, **kwargs)

    # ---- the bitbell backend ----------------------------------------------
    def _init(self, grid: np.ndarray):
        """Every q-shard's carry and one-level step: (carries, steps, j)."""
        carries, steps = [], []
        j = grid.shape[1]
        for r, dev in enumerate(self._qdev):
            eng = self._engines[dev]
            qblock, j = pad_qblock(grid[r])
            with on_device(dev):
                carry = eng._init_carry(qblock)
                carries.append(carry)
                steps.append(eng._stepper(carry))
        return carries, steps, j

    def _chunk(self, carries, steps, bound) -> None:
        """Enqueue up to ``bound`` gated levels (None: to convergence) on
        every q-shard, shard after shard; no host read."""
        for dev, carry, step in zip(self._qdev, carries, steps):
            with on_device(dev):
                bit_level_chunk(carry, step, bound, self._max_levels)

    def _finish(self, carries, j, k, k_pad):
        """The merged (f, levels, reached), (k_pad,) int64 on q-shard 0's
        device (the Gatherv + argmin contract, main.cu:324-397)."""
        return tuple(
            merge_local_f([getattr(c, name) for c in carries], j, self.w, k, k_pad)[0]
            for name in ("f", "levels", "reached")
        )

    def _bitbell_merged(self, grid, k, k_pad):
        carries, steps, j = self._init(grid)
        bound = self.level_chunk or None
        while True:
            self._chunk(carries, steps, bound)
            ctrl = stacked_read([c.ctrl[:2] for c in carries])
            if bound is None or not ctrl[:, 0].any() or ctrl[:, 1].max() >= self._max_levels:
                break
        return self._finish(carries, j, k, k_pad)

    # ---- the csr backend --------------------------------------------------
    def _csr_merged(self, grid, k, k_pad, chunk):
        parts = []
        for r, dev in enumerate(self._qdev):
            eng = self._engines[dev]
            eng.query_chunk = chunk
            with on_device(dev):
                parts.append(eng.f_values(grid[r]))
        record_dispatch()
        return merge_local_f(parts, grid.shape[1], self.w, k, k_pad)[0]

    def f_values(self, queries) -> torch.Tensor:
        """(K, S) -1-padded queries -> (K,) int64 F values (on q-shard 0's
        device)."""
        grid, k, k_pad, chunk = shard_queries(self.mesh, np.asarray(queries), self.query_chunk)
        if self.backend == "bitbell":
            merged, _, _ = self._bitbell_merged(grid, k, k_pad)
        else:
            merged = self._csr_merged(grid, k, k_pad, chunk)
        return merged[:k]

    def query_stats(self, queries):
        """Per-query (levels, reached, F) on the bitbell backend (the
        per-shard counters merge like F values); None on ``csr``."""
        if self.backend != "bitbell":
            return None
        grid, k, k_pad, _ = shard_queries(self.mesh, np.asarray(queries), self.query_chunk)
        f, levels, reached = self._bitbell_merged(grid, k, k_pad)
        record_dispatch()
        return (
            levels[:k].cpu().numpy().astype(np.int32),
            reached[:k].cpu().numpy().astype(np.int32),
            f[:k].cpu().numpy(),
        )

    def level_stats(self, queries):
        """Per-level trace (``MSBFS_STATS=2``) at -gn > 1: the shared
        stepped loop over this engine's init, one-level step and merge."""
        queries = np.asarray(queries)
        grid, k, k_pad, _ = shard_queries(self.mesh, queries, self.query_chunk)
        jj = {}

        def init():
            carries, steps, jj["j"] = self._init(grid)
            return carries, steps

        def step(state):
            self._chunk(*state, 1)
            return state

        def finish(state):
            return self._finish(state[0], jj["j"], k, k_pad)

        def running(state):
            return bool(stacked_read([c.ctrl[:1] for c in state[0]]).any())

        warmed = queries.shape in self._level_warm_shapes
        out = stepped_level_stats(init, step, finish, k, self.max_levels, warmed, running)
        self._level_warm_shapes.add(queries.shape)
        return out
