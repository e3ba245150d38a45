"""Bucketed delta-stepping: distance-to-set over positive integer edge costs.

The JAX package's weighted/deltastep.py on the CUDA device.  Tentative
distances are an (n_state, K) int32 plane, query-minor (a column a query
group, where JAX keeps (K, n) rows); the drive loop walks buckets
``b = tent // delta`` in ascending order.  Within a
bucket the light slots (cost <= delta) relax to a fixpoint, the bucket's
frontier re-entering while improvements land in the bucket; the heavy
slots (cost > delta) relax once at the bucket's close, from everything the
bucket touched (a heavy offer lands at least delta + 1 past the bucket's
floor, so it never reopens it).  ``delta`` is fixed when the engine is
built, so the slots are split then into a light and a heavy side, each in
pieces of a row (ops/cuda_weighted.py ``make_side``), and a pass reads its
own side only.  Every pass is kernel K12 (``csrc/weighted_relax.cu``) over
the run of pieces the flavor hands it, reading the pre-pass plane (Jacobi,
as JAX), so the improved sets, the passes and the five counters equal
JAX's.

The loop keeps JAX's host reads: one ``int`` of the least pending distance
a bucket (and one more to end), one ``bool`` of the frontier a light pass
(and one more to end the bucket), the windowed flavor's row band a pass,
and the final plane's read-back, transposed on the card to JAX's (K, n)
host plane; ``last_host_reads`` counts them.

``MSBFS_DELTA`` overrides the bucket width; unset, it is the rounded mean
slot cost.  Three flavors, negotiated by capability tokens
(weighted/__init__.py), differ only in the slots a pass hands K12:

* :class:`WeightedBitBellEngine` — every dedup slot (the CSR's
  :meth:`..models.csr.CSRGraph.deduped_weighted`, equal to the JAX
  flavor's ``BellGraph`` sparse arrays; no forest is built);
* :class:`WeightedStencilEngine` — ``windowed``: the slots of the active
  rows' band, [start[lo], start[hi]), unpadded (JAX pads the window to a
  power of two only to bound its compiled programs): on each side the
  pieces whose owners lie in the band, one run;
* :class:`WeightedMesh2DEngine` — ``mesh2d``: the slots ordered by the row
  tile that owns their target, one launch a tile (each tile's pieces one
  run), tiles one after another on one device, every tile reading the
  pre-pass plane.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.csr import CSRGraph
from ..ops.cuda_weighted import INF, make_side, relax, relax_plain
from ..ops.engine import QueryEngineBase
from ..runtime.supervisor import InputError
from ..utils import faults, knobs
from ..utils.timing import record_dispatch


def resolve_delta(weights: np.ndarray) -> int:
    """The bucket width: ``MSBFS_DELTA`` when set to a positive int, else
    max(1, round(mean cost)); 1 with no slots."""
    override = knobs.get_int("MSBFS_DELTA", 0)
    if override > 0:
        return override
    if weights is None or len(weights) == 0:
        return 1
    return max(1, int(round(float(np.mean(np.asarray(weights))))))


def _f_of(dist: torch.Tensor) -> torch.Tensor:
    """(K,) int64 sums of the non-negative entries of a (K, n) int32 host
    plane (torch's threaded reduction; NumPy's took most of a second on
    RMAT-20's 64 x 2^20 plane)."""
    return dist.clamp(min=0).sum(dim=1, dtype=torch.int64)


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the weighted engines run on the GPU "
                "(device='cpu' runs the plain version, for tests)"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


class DeltaStepEngineBase(QueryEngineBase):
    """The drive loop; a flavor picks its slots (:meth:`_finalize_arrays`)
    and the slot ranges of a pass (:meth:`_relax`).  ``f_values`` is the
    cost sum over reached vertices, so ``best``, ``compile`` and the
    supervisor apply unchanged.  ``device`` None is the current CUDA
    device; ``plain`` runs K12's plain version on any device."""

    CAPABILITIES = frozenset({"weighted"})

    def __init__(self, graph: CSRGraph, delta: Optional[int] = None,
                 device=None, plain: bool = False, native: bool = True):
        if not isinstance(graph, CSRGraph) or not graph.has_weights:
            raise InputError(
                "weighted engines need a CSRGraph with edge_weights "
                "(generate costs with gen_cli --weights, or load a "
                "weighted .bin/.gr artifact)"
            )
        self.graph = graph
        self.device = _device(device)
        self.plain = bool(plain)
        self.native = bool(native)
        self.n = int(graph.n)
        self.n_state = self.n  # the mesh flavor pads to whole tiles
        u, v, w, _ = graph.deduped_weighted(native)
        max_w = int(w.max()) if w.size else 1
        if int(self.n - 1) * max_w >= INF:
            raise InputError(
                f"weighted diameter bound (n-1)*max_cost = "
                f"{(self.n - 1) * max_w} exceeds the int32 tentative-plane "
                f"range ({INF}); reduce costs or graph size"
            )
        self.delta = int(delta) if delta else resolve_delta(w)
        if self.delta < 1:
            raise InputError(f"delta must be >= 1, got {self.delta}")
        self.max_cost = max_w
        self._u_host, self._v_host, self._w_host = u, v, w
        self._finalize_arrays()
        self.last_stats: dict = {}
        self.last_host_reads = 0

    # -- flavor hooks --------------------------------------------------
    def _split(self, u, v, w, cuts=None):
        """The light and the heavy side of slot arrays in the flavor's
        order (natively a threaded stable partition, ``native=False``
        NumPy masks), each cut into pieces (at ``cuts`` too, positions of
        the whole arrays), uploaded: ``self._sides`` = (light, heavy).
        Returns each side's positions of ``cuts``."""
        if self.native:
            from ..runtime import native_loader

            parts = native_loader.split_slots(u, v, w, self.delta)
        else:
            light = w <= self.delta
            parts = tuple((u[keep], v[keep], w[keep]) for keep in (light, ~light))
        at = [None, None]
        if cuts is not None:
            at[0] = np.array([np.count_nonzero(w[:c] <= self.delta) for c in cuts])
            at[1] = np.asarray(cuts) - at[0]
        self._sides = tuple(make_side(*part, self.device, cut, native=self.native)
                            for part, cut in zip(parts, at))
        return at

    def _finalize_arrays(self) -> None:
        """Split and upload the slots the flavor's passes read."""
        self._split(self._u_host, self._v_host, self._w_host)

    def _pass(self, tent, active, light, p0, p1, out=None):
        """K12 (or its plain version) over pieces [p0, p1) of the pass's
        side."""
        side = self._sides[0 if light else 1]
        if self.plain:
            s0, s1 = side.slot_range(p0, p1)
            return relax_plain(tent, active, side.u, side.v, side.w, self.delta, light,
                               s0, s1, out)
        return relax(tent, active, side, p0, p1, self.delta, light, out)

    def _relax(self, tent, active, light: bool):
        """One relaxation pass; returns (new tent, slots examined: the
        flavor's range on both sides, as JAX counts it)."""
        side = self._sides[0 if light else 1]
        return self._pass(tent, active, light, 0, side.num_pieces), int(self._u_host.size)

    # -- drive loop ----------------------------------------------------
    def distances(self, rows) -> np.ndarray:
        """(K, S) -1-padded source rows -> (K, n) int32 weighted
        distance-to-set fields on the host, -1 = unreached (the device
        plane is (n_state, K)); the bucket accounting lands in
        ``last_stats``."""
        rows = np.asarray(rows, dtype=np.int32)
        if rows.ndim == 1:
            rows = rows[None, :]
        K = rows.shape[0]
        n, ns = self.n, self.n_state
        stats = {
            "delta": int(self.delta),
            "buckets": 0,
            "light_relaxations": 0,
            "heavy_relaxations": 0,
            "bucket_plane_bytes": 0,
        }
        self.last_host_reads = 0
        if K == 0:
            self.last_stats = stats
            return np.zeros((0, n), dtype=np.int32)
        dev = self.device
        tent = torch.full((ns, K), INF, dtype=torch.int32, device=dev)
        valid = (rows >= 0) & (rows < n)
        k_idx = np.repeat(np.arange(K), valid.sum(axis=1))
        tent[torch.from_numpy(rows[valid]).long().to(dev), torch.from_numpy(k_idx).to(dev)] = 0
        settled = torch.zeros((ns, K), dtype=torch.bool, device=dev)
        delta = self.delta
        plane_bytes = K * ns * 4  # one int32 tentative plane pass
        while True:
            m = int(torch.where(settled, INF, tent).min())
            self.last_host_reads += 1
            record_dispatch()
            if m >= INF:
                break
            b = m // delta
            frontier = (tent < INF) & (tent // delta == b) & ~settled
            bucket_members = frontier
            # Light fixpoint: improvements landing back in bucket b
            # re-enter the frontier.
            while True:
                self.last_host_reads += 1
                if not bool(frontier.any()):
                    break
                bucket_members = bucket_members | frontier
                new_tent, slots = self._relax(tent, frontier, light=True)
                improved = new_tent < tent
                tent = new_tent
                frontier = improved & (tent // delta == b)
                record_dispatch()
                stats["light_relaxations"] += K * slots
                stats["bucket_plane_bytes"] += plane_bytes
            # Heavy close: one pass from everything the bucket touched.
            tent, slots = self._relax(tent, bucket_members, light=False)
            record_dispatch()
            stats["heavy_relaxations"] += K * slots
            stats["bucket_plane_bytes"] += plane_bytes
            settled = settled | bucket_members
            stats["buckets"] += 1
        # Unreached cells become -1 on the device and the plane turns to
        # JAX's (K, n) there; it then comes back in one copy into page-locked
        # memory (a pageable copy of RMAT-20's 256 MB plane ran at about
        # 2 GB/s on an H100).
        plane = tent[:n]
        host = torch.empty((K, n), dtype=torch.int32, pin_memory=dev.type == "cuda")
        host.copy_(torch.where(plane >= INF, -1, plane).t().contiguous())
        dist = host.numpy()
        self.last_host_reads += 1
        if faults.corruption_armed():
            # The plane seam (bitflip:wplane): the read-back planes take the
            # same injectable corruption as the bit planes; the certificate
            # must flunk it, never serve it.
            dist = np.asarray(faults.corrupt("wplane", dist))
        self.last_stats = stats
        return dist

    def f_values(self, queries) -> torch.Tensor:
        """(K, S) padded rows -> (K,) int64 weighted cost sums F(U) = sum
        over reached v of dist(U, v), on the host."""
        return _f_of(torch.from_numpy(self.distances(queries)))

    def query_stats(self, queries):
        """(levels, reached, F) numpy arrays, ``levels`` = buckets run."""
        dist = torch.from_numpy(self.distances(queries))
        f = _f_of(dist).numpy()
        reached = (dist >= 0).sum(dim=1, dtype=torch.int32).numpy()
        levels = np.full(dist.shape[0], self.last_stats.get("buckets", 0), dtype=np.int32)
        return levels, reached, f

    def weighted_stats(self) -> dict:
        """Bucket accounting of the last run: delta, buckets, light and
        heavy relaxation candidates, tentative-plane bytes."""
        return dict(self.last_stats)

    def compile(self, queries_shape, warm_stats: bool = False, warm_levels: bool = False) -> None:
        """Build and load the kernels, so the build lands in the
        preprocessing span, then the warm-up run on an all-padding batch."""
        if self.device.type == "cuda" and not self.plain:
            from ..runtime import kernels

            kernels.library()
        super().compile(queries_shape, warm_stats, warm_levels)


class WeightedBitBellEngine(DeltaStepEngineBase):
    """Every pass over all dedup slots: the CSR's ``deduped_weighted``
    arrays, which equal the JAX flavor's ``BellGraph.sparse`` and
    ``sparse_weights``."""

    CAPABILITIES = frozenset({"weighted"})


class WeightedStencilEngine(DeltaStepEngineBase):
    """``windowed``: a pass runs K12 over the active rows' slot window
    only (dedup slots are sorted by row, so rows [lo, hi) own slots
    [start[lo], start[hi]), and on each side the pieces whose owners lie
    in [lo, hi), found by a host search).  The band comes back from the
    card as three numbers a pass (any row active, the first, the last);
    the window is not padded."""

    CAPABILITIES = frozenset({"weighted", "windowed"})

    def _finalize_arrays(self) -> None:
        super()._finalize_arrays()
        self._slot_start = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(self._u_host, minlength=self.n), out=self._slot_start[1:])
        # int64, the dtype of the band's search keys: a search of int32
        # owners for int64 keys casts (copies) the whole array each pass.
        self._owners = tuple(s.host_pieces[:, 2].astype(np.int64) for s in self._sides)

    def _relax(self, tent, active, light: bool):
        # The band from the plane's first and last active cells, reduced
        # over its flat (n_state * K) view: a per-row any over the query
        # axis is an inner reduction, which costs the card more.
        k = active.shape[1]
        flat = active.view(-1).view(torch.uint8)
        band = torch.stack([flat.max(), flat.argmax(), flat.flip(0).argmax()])
        hot, first, last_from_end = (int(x) for x in band.tolist())
        self.last_host_reads += 1
        if not hot:
            return tent, 0
        lo, hi = first // k, active.shape[0] - last_from_end // k
        s0, s1 = int(self._slot_start[lo]), int(self._slot_start[hi])
        width = s1 - s0
        if width == 0:
            return tent, 0
        p0, p1 = np.searchsorted(self._owners[0 if light else 1], np.array((lo, hi)))
        return self._pass(tent, active, light, int(p0), int(p1)), width


class WeightedMesh2DEngine(DeltaStepEngineBase):
    """``mesh2d``: the vertex axis splits into ``tiles`` row blocks; the
    slots are ordered by the block that owns their target (still sorted by
    source row within a block), and a pass runs K12 once a block with
    slots on the pass's side, one after another, each reading the pre-pass
    plane and committing to its own rows (the per-device partial and
    min-combine of a mesh, on one device).  The plane is padded to
    ``tiles * tile`` rows, which the byte counter counts."""

    CAPABILITIES = frozenset({"weighted", "mesh2d"})

    def __init__(self, graph, delta=None, tiles: int = 4, device=None, plain: bool = False,
                 native: bool = True):
        self.tiles = max(1, int(tiles))
        super().__init__(graph, delta=delta, device=device, plain=plain, native=native)

    def _finalize_arrays(self) -> None:
        n, T = self.n, self.tiles
        tile = -(-max(n, 1) // T)
        self.tile = tile
        self.n_state = T * tile
        owner = self._v_host // tile
        order = np.argsort(owner, kind="stable")
        counts = np.bincount(owner, minlength=T)
        tile_start = np.zeros(T + 1, dtype=np.int64)
        np.cumsum(counts, out=tile_start[1:])
        side_starts = self._split(self._u_host[order], self._v_host[order],
                                  self._w_host[order], cuts=tile_start)
        # Each side's pieces of tile t: [tile_pieces[t], tile_pieces[t + 1]).
        self._tile_pieces = tuple(
            np.searchsorted(side.host_pieces[:, 0], starts)
            for side, starts in zip(self._sides, side_starts)
        )

    def _relax(self, tent, active, light: bool):
        out = tent.clone()
        bounds = self._tile_pieces[0 if light else 1]
        for t in range(self.tiles):
            p0, p1 = int(bounds[t]), int(bounds[t + 1])
            if p1 > p0:
                self._pass(tent, active, light, p0, p1, out)
        return out, int(self._u_host.size)
