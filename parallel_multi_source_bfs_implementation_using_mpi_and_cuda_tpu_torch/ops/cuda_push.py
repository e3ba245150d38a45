"""The queue push of the ``push`` and ``ppush`` routes, as hand-written
CUDA kernels (``csrc/queue_push.cu``): K10 ``queue_expand`` and K11
``queue_compact``.

Counterpart of XLA chains of the JAX package: the body of ops/push.py
``_push_chunk`` (a query's frontier queue gathers its rows of the padded
adjacency table and scatters a 1 into a byte hit plane; new = hit &
~visited; the per-query counters; the next queue by ``compact_indices``,
an exclusive cumsum and a dropping scatter) and the union queue of
ops/push_packed.py (``compact_frontier_planes`` over the bit planes).

:class:`QueueCarry` is the ``push`` route's state, one queue a query;
:class:`RowQueueCarry` the ``ppush`` route's, one queue of plane rows
for the whole batch, whose scatter is K3 (``ops/bitbell.py``
``sparse_hits_or`` over the padded table's dedup CSR).  Beside each
kernel is its plain torch version; the wrappers take it for CPU tensors
and launch the kernel for CUDA ones.

The compaction keeps JAX's order: a queue holds the ascending first
``capacity`` ids of the new frontier and its count in full.  After a
truncated level the next levels' counts depend on which ids were kept,
and those counts decide the capacity protocol's overflow line and its
retry, so they must be JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..runtime import kernels
from .bfs import INT32_MAX
from .bitbell import (
    SW_LISTED,
    SW_LISTED_EDGES,
    WORD_BITS,
    PushSwitch,
    _check_device,
    level_go,
    unpack_counts,
)

# A plane tile of the queue mode: 256 threads of 16 bytes each; a row of
# the byte planes is padded to a multiple of 16 bytes.
TILE_BYTES = 4096
ROW_PITCH = 16
# A tile of the row mode: a thread a plane row.
TILE_ROWS = 256
MODE_QUEUE, MODE_ROWS = 0, 1


def byte_pitch(n: int) -> int:
    """Bytes a query's visited and hit rows take: n + 1 (the sentinel's
    byte) rounded up to 16, so every row starts 16-byte aligned."""
    return -(-(n + 1) // ROW_PITCH) * ROW_PITCH


def tiles_of(size: int, per_tile: int) -> int:
    return max(1, -(-size // per_tile))


@dataclass
class QueueCarry:
    """One query's push BFS a row, updated in place by every level (the
    JAX carry (visited, frontier, f, levels, reached, level, updated,
    max_count) with the queue's count beside it).

    ``visited`` and ``hit`` (K, pitch) uint8, byte v of row q for vertex
    v < n, the rest zero; ``hit`` is zero between levels.  ``queue`` (K,
    capacity) int32: the frontier's ids ascending, its first
    ``min(count, capacity)`` entries meaningful; ``count`` the frontier's
    size in full.  ``f`` (K,) int64; ``levels``, ``reached``, ``level``,
    ``updated``, ``stop`` and ``max_count`` (K,) int32.  A query runs a
    level while ``updated`` and ``level < stop`` (the chunk's bound);
    ``ctrl`` (4,) int32: ctrl[0] = some query may run, ctrl[2] the
    compaction's last-block ticket; ``offsets`` (K, tiles + 1) int32
    scratch."""

    n: int
    visited: torch.Tensor
    hit: torch.Tensor
    queue: torch.Tensor
    count: torch.Tensor
    f: torch.Tensor
    levels: torch.Tensor
    reached: torch.Tensor
    level: torch.Tensor
    updated: torch.Tensor
    stop: torch.Tensor
    max_count: torch.Tensor
    offsets: torch.Tensor
    ctrl: torch.Tensor

    @property
    def capacity(self) -> int:
        return int(self.queue.shape[1])

    def touch(self) -> None:
        """No derived state to invalidate (``bfs.arm_chunk`` calls it)."""

    def running(self, max_levels) -> torch.Tensor:
        """0-d bool: some query may run another level."""
        cap = INT32_MAX if max_levels is None else int(max_levels)
        return ((self.updated != 0) & (self.level < cap)).any()

    def outputs(self):
        return self.f, self.levels, self.reached, self.max_count


def queue_carry_init(n: int, rows: torch.Tensor, queries, capacity: int,
                     plain: bool = False) -> QueueCarry:
    """The carry from (K, S) -1-padded host queries: each query's
    in-range sources set in its hit bytes, as the hits of a level -1 that
    nothing has visited, then K11 (``queue_compact``; its plain version
    with ``plain``) counts them at distance 0 — visited, the queue of
    their ascending distinct ids, count = reached = max_count = their
    number, levels = 1 and updated where there is one, F = 0 — as the JAX
    init does."""
    dev = rows.device
    q = torch.as_tensor(queries, dtype=torch.int64).to(dev)
    k = q.shape[0]
    pitch = byte_pitch(n)
    hit = torch.zeros((k, pitch), dtype=torch.uint8, device=dev)
    hit.scatter_(1, torch.where((q >= 0) & (q < n), q, n), 1)
    hit[:, n] = 0
    zeros = [torch.zeros(k, dtype=torch.int32, device=dev) for _ in range(5)]
    carry = QueueCarry(
        n=n, visited=torch.zeros_like(hit), hit=hit,
        queue=torch.full((k, capacity), n, dtype=torch.int32, device=dev),
        count=zeros[0], f=torch.zeros(k, dtype=torch.int64, device=dev),
        levels=zeros[1], reached=zeros[2],
        level=torch.full((k,), -1, dtype=torch.int32, device=dev),
        updated=torch.ones(k, dtype=torch.int32, device=dev), stop=zeros[3],
        max_count=zeros[4],
        offsets=torch.zeros((k, tiles_of(pitch, TILE_BYTES) + 1), dtype=torch.int32,
                            device=dev),
        ctrl=torch.tensor([1, 0, 0, 0], dtype=torch.int32).to(dev),
    )
    (queue_compact_plain if plain else queue_compact)(carry)
    return carry


def _may_run(carry) -> torch.Tensor:
    return (carry.updated != 0) & (carry.level < carry.stop)


def queue_expand_plain(rows: torch.Tensor, carry: QueueCarry) -> None:
    """K10's function in torch: the hit bytes of every running query's
    queued rows' neighbours (sentinel ``n`` skipped)."""
    if not int(carry.ctrl[0]):
        return
    n, k, cap = carry.n, carry.queue.shape[0], carry.capacity
    live = torch.arange(cap, device=rows.device) < torch.clamp(carry.count, max=cap)[:, None]
    live &= _may_run(carry)[:, None]
    nbrs = rows[torch.clamp(carry.queue, 0, n).long()]  # (K, cap, w)
    ok = live[:, :, None] & (nbrs != n)
    qi = torch.arange(k, device=rows.device)[:, None, None].expand_as(nbrs)
    carry.hit[qi[ok], nbrs[ok].long()] = 1


def _check_queue_carry(carry: QueueCarry, rows=None) -> torch.device:
    n, k = carry.n, carry.queue.shape[0]
    pitch = byte_pitch(n)
    if rows is not None and (
        rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[0] != n + 1
        or not rows.is_contiguous()
    ):
        raise ValueError(f"rows must be ({n + 1}, w) contiguous int32")
    for name, shape, dtype in (
        ("visited", (k, pitch), torch.uint8), ("hit", (k, pitch), torch.uint8),
        ("queue", (k, carry.capacity), torch.int32), ("f", (k,), torch.int64),
        ("offsets", (k, tiles_of(pitch, TILE_BYTES) + 1), torch.int32),
        ("ctrl", (4,), torch.int32),
        *((f, (k,), torch.int32) for f in (
            "count", "levels", "reached", "level", "updated", "stop", "max_count")),
    ):
        t = getattr(carry, name)
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be {shape} contiguous {dtype}")
    if not 1 <= k <= 65535:
        raise ValueError(f"K={k}: the queue kernels take 1..65535 queries")
    extra = () if rows is None else (rows,)
    return _check_device(*extra, *(getattr(carry, f) for f in (
        "visited", "hit", "queue", "count", "f", "levels", "reached", "level",
        "updated", "stop", "max_count", "offsets", "ctrl")))


def queue_expand(rows: torch.Tensor, carry: QueueCarry) -> None:
    """Kernel K10 (``csrc/queue_push.cu``): for every running query and
    each of its first ``min(count, capacity)`` queue entries u, a 1 into
    the query's hit byte of every neighbour v != n of u (row u of the
    (n + 1, w) padded table).  Several writers store the same value, so
    plain stores make the OR.  Gated on the device."""
    dev = _check_queue_carry(carry, rows)
    if dev.type == "cpu":
        queue_expand_plain(rows, carry)
        return
    kernels.launch(
        "queue_expand", dev,
        rows.data_ptr(), int(rows.shape[1]), carry.n, carry.queue.shape[0],
        carry.hit.shape[1], carry.hit.data_ptr(), carry.queue.data_ptr(),
        carry.capacity, carry.count.data_ptr(), carry.level.data_ptr(),
        carry.updated.data_ptr(), carry.stop.data_ptr(), carry.ctrl.data_ptr(),
    )


def compact_queue_plain(new: torch.Tensor, capacity: int, fill: int) -> torch.Tensor:
    """(K, m) 0/1 -> (K, capacity) int32: each row's set indices
    ascending, the rest ``fill`` — JAX's ``compact_indices`` row by row
    (exclusive cumsum, a scatter into a (capacity + 1) buffer whose last
    column takes every index past the capacity)."""
    k, m = new.shape
    on = (new > 0).to(torch.int32)
    pos = torch.cumsum(on, dim=1, dtype=torch.int32) - on
    target = torch.where(on > 0, torch.clamp(pos, max=capacity), capacity)
    out = torch.full((k, capacity + 1), fill, dtype=torch.int32, device=new.device)
    ids = torch.arange(m, dtype=torch.int32, device=new.device).expand(k, m)
    out.scatter_(1, target.long(), torch.where(on > 0, ids, fill))
    return out[:, :capacity]


def queue_compact_plain(carry: QueueCarry) -> None:
    """K11's queue mode in torch: for every running query new = hit &
    ~visited, visited |= new, hit cleared, the next queue and the
    counters; then the go flag."""
    if not int(carry.ctrl[0]):
        return
    n = carry.n
    run = _may_run(carry)
    new = carry.hit[:, :n] & ~carry.visited[:, :n] & run[:, None].to(torch.uint8)
    carry.visited[:, :n] |= new
    carry.hit.zero_()
    cnt = new.sum(dim=1, dtype=torch.int32)
    nxt = carry.level + 1
    carry.queue.copy_(torch.where(
        run[:, None], compact_queue_plain(new, carry.capacity, n), carry.queue))
    carry.count.copy_(torch.where(run, cnt, carry.count))
    carry.f += torch.where(run, cnt.to(torch.int64) * nxt.to(torch.int64), 0)
    carry.levels.copy_(torch.where(run & (cnt > 0), nxt + 1, carry.levels))
    carry.reached += torch.where(run, cnt, 0)
    carry.max_count.copy_(torch.where(run, torch.maximum(carry.max_count, cnt),
                                      carry.max_count))
    carry.updated.copy_(torch.where(run, (cnt > 0).to(torch.int32), carry.updated))
    carry.level.copy_(torch.where(run, nxt, carry.level))
    carry.ctrl[:1].copy_(_may_run(carry).any().view(1))


def queue_compact(carry: QueueCarry) -> None:
    """Kernel K11's queue mode (``csrc/queue_push.cu``, three launches in
    one call): new = hit & ~visited and visited |= new, a count per
    4096-byte tile; a block a query scans its tiles' counts and advances
    its counters (count, F += count * (level + 1), levels, reached,
    max_count, level, updated); each tile then writes its new ids at its
    offset while it is below the capacity, ascending, and clears the hit
    bytes; the last block rewrites ctrl[0].  Gated on the device."""
    dev = _check_queue_carry(carry)
    if dev.type == "cpu":
        queue_compact_plain(carry)
        return
    k, pitch = carry.hit.shape
    kernels.launch(
        "queue_compact", dev, MODE_QUEUE,
        carry.hit.data_ptr(), carry.visited.data_ptr(), None, carry.n, k, pitch,
        carry.queue.data_ptr(), carry.capacity, carry.count.data_ptr(),
        carry.f.data_ptr(), carry.levels.data_ptr(), carry.reached.data_ptr(),
        carry.level.data_ptr(), carry.updated.data_ptr(), carry.stop.data_ptr(),
        carry.max_count.data_ptr(), None, carry.offsets.data_ptr(),
        carry.offsets.shape[1] - 1, None, None, carry.ctrl.data_ptr(), INT32_MAX,
        variant="queue",
    )


@dataclass
class RowQueueCarry:
    """The ``ppush`` route's union-queue BFS, updated in place by every
    level.  ``visited``, ``frontier`` and ``hits`` (n, W) int32 bit
    planes, query 32j + b in bit b of word j; ``hits`` is zero between
    levels.  ``f`` (32W,) int64, ``levels``, ``reached`` and ``counts``
    (scratch, zero between levels) (32W,) int32.  The queue is
    ``switch``'s worklist, as K3's walk reads it: row 0 the frontier's
    nonzero rows ascending, at most its capacity, row 1 each one's first
    edge in the level's edge space (the exclusive prefix of
    ``switch.count``, the rows' out-degrees in the CSR K3 walks), their
    number and edges in ``switch.state``; ``count`` (1,) the frontier's
    rows in full and ``peak`` (1,) the most rows of a frontier a level
    ran on.  ``ctrl`` (4,) int32: [updated, level, scratch, DIR_PUSH];
    ``offsets`` (2, tiles + 1) int32 scratch."""

    visited: torch.Tensor
    frontier: torch.Tensor
    hits: torch.Tensor
    f: torch.Tensor
    levels: torch.Tensor
    reached: torch.Tensor
    counts: torch.Tensor
    switch: PushSwitch
    count: torch.Tensor
    peak: torch.Tensor
    offsets: torch.Tensor
    ctrl: torch.Tensor

    @property
    def n(self) -> int:
        return int(self.visited.shape[0])

    @property
    def capacity(self) -> int:
        return self.switch.capacity

    def running(self, max_levels) -> torch.Tensor:
        cap = INT32_MAX if max_levels is None else int(max_levels)
        return (self.ctrl[0] != 0) & (self.ctrl[1] < cap)

    def outputs(self):
        return self.f, self.levels, self.reached, self.peak


def row_queue_plain(frontier: torch.Tensor, switch: PushSwitch) -> torch.Tensor:
    """The union queue of an (n, W) plane in torch: its nonzero rows
    ascending into ``switch``'s worklist, at most its capacity, each with
    its first edge (the exclusive prefix of the listed rows' out-degrees,
    ``switch.count``), their number and edges into its state; returns the
    (1,) int32 count of nonzero rows in full.  Device ops only."""
    n = frontier.shape[0]
    nz = (frontier != 0).any(dim=1)
    ids = compact_queue_plain(nz[None, :], switch.capacity, n)[0]
    deg = torch.where(ids < n, switch.count[torch.clamp(ids, max=max(n - 1, 0)).long()], 0)
    first = torch.cumsum(deg, 0, dtype=torch.int32) - deg
    count = nz.sum(dtype=torch.int32).view(1)
    switch.worklist[0].copy_(ids)
    switch.worklist[1].copy_(first)
    switch.state[SW_LISTED] = torch.clamp(count, max=switch.capacity)[0]
    switch.state[SW_LISTED_EDGES] = deg.sum()
    return count


def row_compact_plain(carry: RowQueueCarry, max_levels: int = INT32_MAX) -> None:
    """K11's row mode in torch: new = hits & ~visited, visited |= new,
    frontier = new, hits cleared; the per-query counters and the control;
    then the union queue of the new frontier, and its rows into ``peak``
    when a next level may run (the JAX loop counts a frontier's rows at
    the start of the level that expands it)."""
    if not level_go(carry.ctrl, max_levels):
        return
    level = int(carry.ctrl[1])
    new = carry.hits & ~carry.visited
    carry.visited |= new
    carry.frontier.copy_(new)
    carry.hits.zero_()
    counts = unpack_counts(new)
    found = counts > 0
    carry.f += counts.to(torch.int64) * (level + 1)
    carry.levels.copy_(torch.where(found, level + 2, carry.levels))
    carry.reached += counts
    carry.ctrl[0] = int(found.any())
    carry.ctrl[1] = level + 1
    carry.count.copy_(row_queue_plain(carry.frontier, carry.switch))
    if level + 1 < max_levels:
        torch.maximum(carry.peak, carry.count, out=carry.peak)


def _check_row_carry(carry: RowQueueCarry) -> torch.device:
    rows, w = carry.visited.shape
    for name in ("visited", "frontier", "hits"):
        t = getattr(carry, name)
        if t.dtype != torch.int32 or tuple(t.shape) != (rows, w) or not t.is_contiguous():
            raise ValueError(f"{name} must be ({rows}, {w}) contiguous int32")
    for name, dtype in (("f", torch.int64), ("levels", torch.int32),
                        ("reached", torch.int32), ("counts", torch.int32)):
        t = getattr(carry, name)
        if t.dtype != dtype or tuple(t.shape) != (w * WORD_BITS,):
            raise ValueError(f"{name} must be ({w * WORD_BITS},) {dtype}")
    if tuple(carry.offsets.shape) != (2, tiles_of(rows, TILE_ROWS) + 1):
        raise ValueError("offsets must be (2, tiles + 1)")
    sw = carry.switch
    if sw.count.dtype != torch.int32 or tuple(sw.count.shape) != (rows,):
        raise ValueError(f"switch count must be ({rows},) int32 out-degrees")
    if not sw.worklist.is_contiguous() or sw.worklist.shape[0] != 2:
        raise ValueError("worklist must be a contiguous (2, capacity) int32")
    return _check_device(
        carry.visited, carry.frontier, carry.hits, carry.f, carry.levels,
        carry.reached, carry.counts, carry.count, carry.peak, carry.offsets,
        carry.ctrl, sw.count, sw.worklist, sw.state,
    )


def row_compact(carry: RowQueueCarry, max_levels: int = INT32_MAX) -> None:
    """Kernel K11's row mode (``csrc/queue_push.cu``, three launches in
    one call): the level's apply over 256-row tiles (new = hits &
    ~visited, visited |= new, frontier = new, hits cleared, per-lane
    counts, the tile's nonzero rows and their out-degrees); one block
    scans both and advances the counters, the control, ``count``,
    ``peak`` and the worklist's state; each tile then lists its nonzero
    rows with their first edges at its offsets while below the capacity,
    ascending.  Gated on the device (``level_go``)."""
    dev = _check_row_carry(carry)
    if dev.type == "cpu":
        row_compact_plain(carry, max_levels)
        return
    rows, w = carry.visited.shape
    sw = carry.switch
    kernels.launch(
        "queue_compact", dev, MODE_ROWS,
        carry.hits.data_ptr(), carry.visited.data_ptr(), carry.frontier.data_ptr(),
        rows, w, w, sw.worklist.data_ptr(), sw.capacity, carry.count.data_ptr(),
        carry.f.data_ptr(), carry.levels.data_ptr(), carry.reached.data_ptr(),
        None, None, None, carry.peak.data_ptr(), carry.counts.data_ptr(),
        carry.offsets.data_ptr(), carry.offsets.shape[1] - 1, sw.state.data_ptr(),
        sw.count.data_ptr(), carry.ctrl.data_ptr(), int(max_levels),
        variant="rows",
    )
