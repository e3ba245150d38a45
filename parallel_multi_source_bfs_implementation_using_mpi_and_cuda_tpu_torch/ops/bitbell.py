"""The shared bit-plane level loop: 32 queries per word, OR-fold frontiers.

Query 32w+b lives in bit b of word w of a vertex's row (the JAX package's
ops/bitbell.py layout); planes are (n, W) int32 tensors whose bits are
read as uint32 (bit 31 makes a word negative: every shift here is masked).
The objective F(U) = sum of distances (reference main.cu:75-89) is
accumulated per level — a level that discovers c_q new vertices for query
q at distance l adds l * c_q — so no per-vertex distance is ever stored.

Loop state (:class:`BitCarry`): two (n, W) planes, the per-query
counters (f int64, levels, reached int32), and a device-resident control
vector (updated, level) that the level-apply kernel advances.  Keeping
the control on the device lets the host enqueue a whole chunk of levels
with no round trip: launches past convergence return at once, and the
host reads the control once per chunk (:func:`bit_level_chunk`).

Kernels: :func:`bit_level_apply` launches ``csrc/level_apply.cu``,
:func:`sparse_hits_or` (the thin-frontier push) ``csrc/push_or.cu`` and
:func:`pack_sources` (a batch's source planes, at a stride of 1 lane a
query or 8 for byte planes) ``csrc/pack_sources.cu`` on CUDA tensors;
each runs its ``*_plain`` version — the same function in torch — on CPU
tensors only.

A direction-switched route carries a :class:`PushSwitch` in its carry:
the level apply counts the new frontier's active rows and their edges,
lists the rows the push will expand and writes the next level's
direction into ctrl[3], so a level enqueues only its kernels (the push
and the pull, each gated on ctrl[3], then the apply).  The push ORs into
a hit plane of its own, which the apply clears as it consumes it; the
pull rewrites its plane whole.  The sources' direction and list are made
once per batch (:func:`bit_level_init`).

:class:`BitBellEngine` is the default route: the BELL reduction forest
(``csrc/forest_or.cu``, :mod:`.cuda_bell`) for dense levels and the push
for thin ones, the direction decided per level on the device.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..runtime import kernels
from ..utils import knobs
from ..utils.timing import record_dispatch
from .bfs import validate_level_chunk
from .engine import frontier_activity
from .objective import select_best
from .packed import PackedEngineBase

WORD_BITS = 32
INT32_MAX = 2**31 - 1

# Level chunks fused per host sync when the chunk bound is automatic
# (same factor as the JAX package): the loop stops on convergence either
# way, so fusion only cuts the number of status reads.
_AUTO_MEGACHUNK = 8

# On CUDA the chunk loop looks at a non-blocking copy of the control every
# this many levels and stops enqueueing no-op launches once it shows the
# BFS converged.
_PEEK_EVERY = 8


def resolve_megachunk(megachunk, level_chunk) -> int:
    """Chunks fused per host sync: ``None`` = ``MSBFS_MEGACHUNK`` when set,
    else 8.  Callers whose ``level_chunk`` is a deliberate bound pass 1.
    Unchunked engines have nothing to fuse: always 1."""
    if not level_chunk:
        return 1
    if megachunk is None:
        env = knobs.raw("MSBFS_MEGACHUNK", "")
        if env:
            try:
                megachunk = int(env)
            except ValueError:
                megachunk = None
    if megachunk is None:
        megachunk = _AUTO_MEGACHUNK
    megachunk = int(megachunk)
    if megachunk <= 0:
        raise ValueError(f"megachunk must be positive (got {megachunk})")
    return megachunk


def _low32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def _pack_width(k: int, lane_stride: int) -> int:
    """Words a row of a (K, S) batch packed at ``lane_stride`` lanes a
    query (at least one)."""
    if lane_stride < 1:
        raise ValueError(f"lane_stride must be positive (got {lane_stride})")
    return max(1, -(-k * lane_stride // WORD_BITS))


def pack_sources_plain(
    queries: torch.Tensor, n: int, plane: torch.Tensor, counts: torch.Tensor,
    lane_stride: int = 1,
) -> None:
    """The pack kernel's function in torch (same in-place effect): query
    q's in-range sources set bit q * ``lane_stride`` of their rows of the
    zero ``plane``, and ``counts`` (zero, one entry a lane) gains at that
    lane the number of distinct sources.  Duplicate (vertex, query) pairs
    are removed first, so an int64 scatter-add of each pair's bit is an OR;
    the low 32 bits then become the int32 word."""
    k = queries.shape[0]
    w = plane.shape[1]
    if queries.numel() == 0:
        return
    q = queries.to(torch.int64)
    valid = (q >= 0) & (q < n)
    qi = torch.nonzero(valid, as_tuple=True)[0]
    keys = torch.unique(q[valid] * k + qi)
    vert, bit = keys // k, (keys % k) * lane_stride
    flat = torch.zeros(n * w, dtype=torch.int64, device=plane.device)
    flat.scatter_add_(0, vert * w + bit // WORD_BITS, torch.ones_like(bit) << (bit % WORD_BITS))
    plane |= _low32(flat).view(n, w)
    counts += torch.bincount(bit, minlength=w * WORD_BITS).to(torch.int32)


def pack_sources(
    queries: torch.Tensor, n: int, plane: torch.Tensor, counts: torch.Tensor,
    lane_stride: int = 1,
) -> None:
    """Kernel K4 (``csrc/pack_sources.cu``): (K, S) -1-padded int32
    queries -> the (n, W) source plane (query q at bit q * ``lane_stride``;
    stride 1 packs 32 queries a word, stride 8 puts query q in byte q of a
    row) and the per-lane distinct-source counts (32W,), into a zero
    ``plane`` and zero ``counts``.  Sources outside [0, n), the -1 padding
    among them, are dropped — the reference's bounds check
    (main.cu:46-51).  An empty batch launches nothing."""
    if queries.dtype != torch.int32 or queries.dim() != 2 or not queries.is_contiguous():
        raise ValueError("queries must be a contiguous (K, S) int32 tensor")
    k, s = queries.shape
    w = _pack_width(k, lane_stride)
    _check_plane("plane", plane, (n, w))
    _check_plane("counts", counts, (w * WORD_BITS,))
    dev = _check_device(queries, plane, counts)
    if dev.type == "cpu":
        pack_sources_plain(queries, n, plane, counts, lane_stride)
        return
    if k * s == 0:
        return
    kernels.launch(
        "pack_sources", dev, queries.data_ptr(), k, s, n, plane.data_ptr(), w,
        int(lane_stride), counts.data_ptr(), variant=f"stride{lane_stride}",
    )


def _source_buffers(n: int, queries, device, lane_stride: int):
    q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.int32)).to(device)
    w = _pack_width(q.shape[0], lane_stride)
    plane = torch.zeros((n, w), dtype=torch.int32, device=device)
    return q, plane, torch.zeros(w * WORD_BITS, dtype=torch.int32, device=device)


def pack_queries(
    n: int, queries: np.ndarray, device, lane_stride: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, S) -1-padded host queries -> the (n, W) int32 source plane and
    the (32W,) int32 per-lane source counts, W = ceil(K * lane_stride /
    32) (at least 1), packed by :func:`pack_sources` on ``device``: query
    q's count at lane q * ``lane_stride``.  Stride 1 is the JAX package's
    ``pack_queries`` (K a multiple of 32 there), stride 8 its
    ``lowk_pack`` on a 4W-byte row."""
    q, plane, counts = _source_buffers(n, queries, device, lane_stride)
    pack_sources(q, n, plane, counts, lane_stride)
    return plane, counts


def pack_queries_plain(
    n: int, queries: np.ndarray, device, lane_stride: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_queries` through the plain version on any device."""
    q, plane, counts = _source_buffers(n, queries, device, lane_stride)
    pack_sources_plain(q, n, plane, counts, lane_stride)
    return plane, counts


def unpack_counts(words: torch.Tensor) -> torch.Tensor:
    """(n, W) int32 bit planes -> (W*32,) int32 per-query set-bit counts."""
    n, w = words.shape
    counts = torch.empty((w, WORD_BITS), dtype=torch.int64, device=words.device)
    for b in range(WORD_BITS):
        counts[:, b] = ((words >> b) & 1).sum(dim=0)
    return counts.reshape(w * WORD_BITS).to(torch.int32)


def unpack_byte_planes(words: torch.Tensor) -> torch.Tensor:
    """(m, W) int32 bit planes -> (m, W*32) uint8 0/1 byte planes."""
    m, w = words.shape
    bits = (words.unsqueeze(-1) >> _shifts(words.device)) & 1
    return bits.to(torch.uint8).reshape(m, w * WORD_BITS)


def pack_byte_planes(bytes_: torch.Tensor) -> torch.Tensor:
    """(m, K) 0/1 byte planes -> (m, K/32) int32 bit planes (a sum of
    disjoint shifted bits is their OR)."""
    m, k = bytes_.shape
    b = bytes_.reshape(m, k // WORD_BITS, WORD_BITS).to(torch.int64)
    shifts = _shifts(bytes_.device).to(torch.int64)
    return _low32((b << shifts).sum(dim=2))


# ctrl[3]: which expansion runs the level on a direction-switched route
# (csrc/msbfs_common.cuh kDirMatmul / kDirPull / kDirPush): direction 0 is
# the matmul on the mxu route and the forest pull on the bitbell route.
DIR_MATMUL = 0
DIR_PULL = 0
DIR_PUSH = 1

# The switch state's int64 words (csrc/msbfs_common.cuh): the worklist's
# length and the edges of its rows, then the predicate's inputs; the rest
# is the apply's scratch.
SW_LISTED, SW_LISTED_EDGES, SW_ACTIVE_ROWS, SW_ACTIVE_EDGES = range(4)
SWITCH_WORDS = 8


@dataclass
class PushSwitch:
    """The direction switch of one batch on a hybrid route.

    A level pushes when its frontier has at most ``row_limit`` active rows
    and those have at most ``edge_limit`` dedup out-edges (``count``, the
    (rows,) int32 out-degrees).  ``worklist`` (2, capacity) int32: the
    active rows that have out-edges, then each one's exclusive prefix of
    out-degrees in list order; capacity = min(row_limit, rows), so a
    level the predicate sends to the push is always listed whole.
    ``state`` (:data:`SWITCH_WORDS`,) int64, see ``SW_*``; the edges of
    the listed rows are exact when the list is whole.  ``hits`` (rows, W)
    int32: the push's hit plane, all zero between levels."""

    count: torch.Tensor
    row_limit: int
    edge_limit: int
    worklist: torch.Tensor
    state: torch.Tensor
    hits: torch.Tensor

    @classmethod
    def new(
        cls, count: torch.Tensor, row_limit: int, edge_limit: int, width: int
    ) -> "PushSwitch":
        rows = int(count.shape[0])
        capacity = max(0, min(int(row_limit), rows))
        dev = count.device
        return cls(
            count, int(row_limit), int(edge_limit),
            torch.zeros((2, capacity), dtype=torch.int32, device=dev),
            torch.zeros(SWITCH_WORDS, dtype=torch.int64, device=dev),
            torch.zeros((rows, int(width)), dtype=torch.int32, device=dev),
        )

    @property
    def capacity(self) -> int:
        return int(self.worklist.shape[1])

    def listed(self) -> torch.Tensor:
        """The listed rows (a host read of the length)."""
        return self.worklist[0, : int(self.state[SW_LISTED])]


def switch_record(switch: PushSwitch, frontier: torch.Tensor, ctrl: torch.Tensor) -> None:
    """The apply's switch epilogue in torch, on a frontier: the worklist
    (in row order), the state and the direction in ctrl[3].  Host reads:
    the plain versions and once per batch for the sources."""
    active, cnt, _ = frontier_activity(frontier, switch.count)
    edges = torch.where(active, switch.count, 0).sum(dtype=torch.int64)
    rows = torch.nonzero(active & (switch.count > 0)).flatten()
    deg = switch.count[rows].to(torch.int64)
    length = min(int(rows.shape[0]), switch.capacity)
    switch.worklist[0, :length] = rows[:length].to(torch.int32)
    switch.worklist[1, :length] = (torch.cumsum(deg, 0) - deg)[:length].to(torch.int32)
    switch.state.zero_()
    switch.state[SW_LISTED] = length
    switch.state[SW_LISTED_EDGES] = deg.sum()
    switch.state[SW_ACTIVE_ROWS] = cnt.to(torch.int64)
    switch.state[SW_ACTIVE_EDGES] = edges
    push = int(cnt) <= switch.row_limit and int(edges) <= switch.edge_limit
    ctrl[3] = DIR_PUSH if push else DIR_PULL


@dataclass
class BitCarry:
    """The level loop's state, updated in place by every level.

    ``ctrl`` is a (4,) int32 device vector: [updated, level, blocks done
    (the level-apply kernel's scratch), direction of the next level
    (:data:`DIR_MATMUL` or :data:`DIR_PUSH`, written by the apply of a
    direction-switched route, whose :class:`PushSwitch` is ``switch``)].
    ``counts`` is (K,) int32 scratch the level-apply kernel accumulates
    into and clears."""

    visited: torch.Tensor  # (n, W) int32
    frontier: torch.Tensor  # (n, W) int32
    f: torch.Tensor  # (K,) int64
    levels: torch.Tensor  # (K,) int32
    reached: torch.Tensor  # (K,) int32
    counts: torch.Tensor  # (K,) int32
    ctrl: torch.Tensor  # (4,) int32
    switch: Optional[PushSwitch] = None
    k: int = 0  # queries of the batch (with its padding): a byte plane's real lanes

    def rows(self, lo: int, count: int) -> "BitCarry":
        """A view of rows [lo, lo + count) of both planes sharing the
        counters and control (the active-row window)."""
        if lo == 0 and count == self.visited.shape[0]:
            return self
        return BitCarry(
            self.visited[lo : lo + count],
            self.frontier[lo : lo + count],
            self.f, self.levels, self.reached, self.counts, self.ctrl,
        )


def bit_level_init(
    frontier0: torch.Tensor, counts0: torch.Tensor,
    switch: Optional[PushSwitch] = None,
) -> BitCarry:
    """The carry with sources counted at distance 0: visited = frontier =
    sources, levels = 1 for queries with a source, reached = sources;
    with a ``switch``, the first level's direction and worklist from the
    sources (:func:`switch_record`)."""
    dev = frontier0.device
    carry = BitCarry(
        visited=frontier0.clone(),
        frontier=frontier0,
        f=torch.zeros(counts0.shape, dtype=torch.int64, device=dev),
        levels=(counts0 > 0).to(torch.int32),
        reached=counts0.clone(),
        counts=torch.zeros_like(counts0),
        ctrl=torch.tensor(
            [int((counts0 > 0).any()), 0, 0, 0], dtype=torch.int32, device=dev
        ),
        switch=switch,
    )
    if switch is not None:
        switch_record(switch, frontier0, carry.ctrl)
    return carry


def level_go(ctrl: torch.Tensor, max_levels: int) -> bool:
    """Host read of the control: may the next level run?  A device
    sync on CUDA tensors — the plain versions only."""
    updated, level = ctrl[:2].tolist()
    return bool(updated) and level < max_levels


def _check_plane(name: str, t: torch.Tensor, shape=None) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_device(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# Plane widths the sweep and apply kernels instantiate as templates; other
# widths run their generic code.
KERNEL_WIDTHS = (1, 2, 4, 8)


def check_index_range(rows: int, w: int) -> None:
    """The sweep and apply kernels index words with 32-bit ints."""
    if rows * w >= 2**31:
        raise ValueError(
            f"a ({rows}, {w}) plane has {rows * w} words: the kernels index "
            "at most 2^31 - 1"
        )


class ApplyPlan(NamedTuple):
    """How the level-apply kernel runs one launch (:func:`apply_plan`)."""

    variant: str  # "vector" (W in KERNEL_WIDTHS), "column" or "rows" (other W)
    w_instance: int  # the template width, or 0 for the column and rows variants
    vec16: bool  # 16-byte loads and stores
    switch: bool = False  # with the direction switch's epilogue


# The C entry point's variant codes.
_APPLY_VARIANTS = {"vector": 0, "column": 1, "rows": 2}


def apply_plan(w: int, vec16: bool = True, switch: bool = False) -> ApplyPlan:
    """The apply's variant for planes of w words a row: a pure function of
    the shapes (``vec16``: every plane's base pointer is 16-byte aligned;
    ``switch``: the direction switch's epilogue runs).  The vector variant
    gives a lane units of 4 (or 8) consecutive words, so word c of a unit
    belongs to query word c % w only for w in KERNEL_WIDTHS; the column
    variant takes every other w with 4-byte loads, a warp a word column,
    and the rows variant, a lane a whole row, takes them with a switch
    (which must see whole rows)."""
    if w in KERNEL_WIDTHS:
        return ApplyPlan("vector", w, bool(vec16), bool(switch))
    if switch:
        return ApplyPlan("rows", 0, False, True)
    return ApplyPlan("column", 0, False)


@functools.lru_cache(maxsize=256)
def plan_label(plan) -> str:
    """A sweep or apply plan as the variant tally names it:
    "ring/W1/vec16", "column/Wn/vec4", "vector/W2/vec16/switch"."""
    width = f"W{plan.w_instance}" if plan.w_instance else "Wn"
    label = f"{plan.variant}/{width}/{'vec16' if plan.vec16 else 'vec4'}"
    return label + ("/switch" if getattr(plan, "switch", False) else "")


def bit_level_apply_plain(
    carry: BitCarry, hits: torch.Tensor, max_levels: int = INT32_MAX
) -> None:
    """The level-apply kernel's function in torch (same in-place effect)."""
    if not level_go(carry.ctrl, max_levels):
        return
    level = int(carry.ctrl[1])
    pushed = carry.switch is not None and int(carry.ctrl[3]) == DIR_PUSH
    if pushed:
        hits = carry.switch.hits
    new = hits & ~carry.visited
    carry.visited |= new
    carry.frontier.copy_(new)
    counts = unpack_counts(new)
    found = counts > 0
    carry.f += counts.to(torch.int64) * (level + 1)
    carry.levels.copy_(torch.where(found, level + 2, carry.levels))
    carry.reached += counts
    carry.ctrl[0] = int(found.any())
    carry.ctrl[1] = level + 1
    if carry.switch is not None:
        switch_record(carry.switch, carry.frontier, carry.ctrl)
    if pushed:
        hits.zero_()


def bit_level_apply(
    carry: BitCarry, hits: torch.Tensor, max_levels: int = INT32_MAX
) -> None:
    """Fold one level's hit planes into the carry (kernel C,
    ``csrc/level_apply.cu``): new = hits & ~visited, visited |= new,
    frontier = new, per-query counts into f/levels/reached, then advance
    the device control.  With ``carry.switch`` the hits of a level that
    ctrl[3] sent to the push are the switch's plane, which the apply
    leaves all zero, and ``hits`` otherwise; the apply then lists the new
    frontier's rows and writes the next level's direction into ctrl[3]
    (:func:`switch_record`).  Gated on the device: a no-op once converged
    or at ``max_levels``.  The kernel's variant is :func:`apply_plan`'s."""
    rows, w = carry.visited.shape
    _check_plane("visited", carry.visited)
    _check_plane("frontier", carry.frontier, (rows, w))
    _check_plane("hits", hits, (rows, w))
    for name, t, dtype in (
        ("f", carry.f, torch.int64), ("levels", carry.levels, torch.int32),
        ("reached", carry.reached, torch.int32),
        ("counts", carry.counts, torch.int32),
    ):
        if t.dtype != dtype or tuple(t.shape) != (w * WORD_BITS,):
            raise ValueError(f"{name} must be ({w * WORD_BITS},) {dtype}")
    _check_plane("ctrl", carry.ctrl, (4,))
    if w > 1024:
        raise ValueError(f"W={w} words exceed the kernel's shared-memory counts")
    sw = carry.switch
    extra = () if sw is None else (sw.count, sw.worklist, sw.state, sw.hits)
    if sw is not None:
        _check_switch(sw, rows, w)
    dev = _check_device(
        hits, carry.visited, carry.frontier, carry.f, carry.levels,
        carry.reached, carry.counts, carry.ctrl, *extra,
    )
    if dev.type == "cpu":
        bit_level_apply_plain(carry, hits, max_levels)
        return
    check_index_range(rows, w)
    ptrs = (hits.data_ptr(), carry.visited.data_ptr(), carry.frontier.data_ptr())
    push_ptr = 0 if sw is None else sw.hits.data_ptr()
    plan = apply_plan(
        w, (ptrs[0] | ptrs[1] | ptrs[2] | push_ptr) % 16 == 0, sw is not None
    )
    switch_args = (None, None, 0, None, None, 0, 0) if sw is None else (
        sw.count.data_ptr(), sw.worklist.data_ptr(), sw.capacity,
        sw.state.data_ptr(), push_ptr, sw.row_limit, sw.edge_limit,
    )
    kernels.launch(
        "level_apply", dev, *ptrs,
        rows, w, carry.counts.data_ptr(), carry.f.data_ptr(),
        carry.levels.data_ptr(), carry.reached.data_ptr(),
        carry.ctrl.data_ptr(), int(max_levels),
        _APPLY_VARIANTS[plan.variant], int(plan.vec16), *switch_args,
        variant=plan_label(plan),
    )


def _check_switch(sw: PushSwitch, rows: int, w: int) -> None:
    _check_plane("switch count", sw.count, (rows,))
    _check_plane("push hits", sw.hits, (rows, w))
    _check_plane("worklist", sw.worklist)
    if sw.worklist.dim() != 2 or sw.worklist.shape[0] != 2 or sw.capacity > rows:
        raise ValueError(f"worklist must be (2, <= {rows}) int32")
    if sw.state.dtype != torch.int64 or tuple(sw.state.shape) != (SWITCH_WORDS,):
        raise ValueError(f"switch state must be ({SWITCH_WORDS},) int64")


def direction_go(ctrl: torch.Tensor, max_levels: int, direction: int) -> bool:
    """Host read of the control: may the level run, in ``direction``?
    A device sync on CUDA tensors — the plain versions only."""
    return level_go(ctrl, max_levels) and int(ctrl[3]) == direction


def default_sparse_budget(e: int) -> int:
    """Auto push edge budget: about E/64 edges, floored at 2^14 so small
    graphs' thin levels qualify, capped at 2^23 (the JAX package's)."""
    return int(min(max(e // 64, 1 << 14), 1 << 23))


def listed_edges(switch: PushSwitch, start, vals) -> Tuple[torch.Tensor, torch.Tensor]:
    """(owner, neighbour) int64 of every dedup edge of the rows on
    ``switch``'s worklist (a host read of its length)."""
    ids = switch.listed().long()
    deg = switch.count[ids].long()
    owner = torch.repeat_interleave(ids, deg)
    # Edge slot j of owner i sits at start[i] + (j - first slot of i).
    shift = start[ids].long() - (torch.cumsum(deg, 0) - deg)
    eidx = torch.arange(owner.shape[0], device=ids.device) + torch.repeat_interleave(shift, deg)
    return owner, vals[eidx].long()


def sparse_hits_or_plain(
    frontier, start, vals, hits, ctrl, switch, max_levels=INT32_MAX
) -> None:
    """The push kernel's function in torch: the dedup neighbours of every
    listed row gain its words (byte lanes, ``index_add_``, ``> 0``, pack),
    ORed into ``hits`` when the control routes the level to push."""
    if not direction_go(ctrl, max_levels, DIR_PUSH):
        return
    owner, nbr = listed_edges(switch, start, vals)
    if not owner.numel():
        return
    acc = torch.zeros(
        (frontier.shape[0], frontier.shape[1] * WORD_BITS), dtype=torch.int32,
        device=hits.device,
    )
    acc.index_add_(0, nbr, unpack_byte_planes(frontier[owner]).to(torch.int32))
    hits |= pack_byte_planes((acc > 0).to(torch.uint8))


def sparse_hits_or(
    frontier: torch.Tensor,
    start: torch.Tensor,
    vals: torch.Tensor,
    hits: torch.Tensor,
    ctrl: torch.Tensor,
    switch: PushSwitch,
    max_levels: int = INT32_MAX,
) -> None:
    """Kernel K3 (``csrc/push_or.cu``), the push scatter-OR over the dedup
    CSR (``start`` per row, neighbour ``vals``): hits[v] |= frontier[u]
    for every dedup edge u -> v of a row u on ``switch``'s worklist, into
    a hit plane that is all zero (on the routes, ``switch.hits``, which
    the switched apply leaves so).
    Gated on the device: runs when the level may run and ctrl[3] is
    :data:`DIR_PUSH`, else leaves ``hits`` untouched.  Exact for any
    frontier the predicate routes here (no budget compaction)."""
    rows, w = frontier.shape
    _check_plane("frontier", frontier)
    _check_plane("hits", hits, (rows, w))
    _check_plane("start", start, (rows,))
    _check_plane("vals", vals)
    _check_plane("ctrl", ctrl, (4,))
    _check_switch(switch, rows, w)
    dev = _check_device(
        frontier, start, vals, hits, ctrl, switch.count, switch.worklist, switch.state
    )
    if dev.type == "cpu":
        sparse_hits_or_plain(frontier, start, vals, hits, ctrl, switch, max_levels)
        return
    check_index_range(rows, w)
    kernels.launch(
        "push_or", dev,
        frontier.data_ptr(), start.data_ptr(), vals.data_ptr(), hits.data_ptr(),
        rows, w, switch.worklist.data_ptr(), switch.capacity,
        switch.state.data_ptr(), min(switch.edge_limit, int(vals.shape[0])),
        int(frontier.data_ptr() % 16 == 0), ctrl.data_ptr(), int(max_levels),
    )


class _ConvergencePeek:
    """Answers "has the loop stopped?" without blocking.  On the CPU it
    reads the control directly.  On CUDA it keeps one non-blocking copy
    of the control in pinned memory in flight and reads it once its event
    has completed, so the host never waits on the device here."""

    def __init__(self, ctrl: torch.Tensor, max_levels: int):
        self.ctrl = ctrl
        self.max_levels = max_levels
        self.calls = 0
        self.event = None
        if ctrl.is_cuda:
            self.buf = torch.empty(4, dtype=torch.int32, pin_memory=True)

    def stopped(self) -> bool:
        if not self.ctrl.is_cuda:
            return not level_go(self.ctrl, self.max_levels)
        self.calls += 1
        if self.event is None:
            if (self.calls - 1) % _PEEK_EVERY == 0:
                self.buf.copy_(self.ctrl, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record()
            return False
        if not self.event.query():
            return False
        self.event = None
        return not level_go(self.buf, self.max_levels)


def bit_level_chunk(
    carry: BitCarry,
    step: Callable[[BitCarry], None],
    chunk: Optional[int],
    max_levels: int = INT32_MAX,
) -> None:
    """Advance the carry by at most ``chunk`` levels (``None``: until
    convergence or ``max_levels``).  ``step(carry)`` runs one gated level.

    Exactly ``chunk`` gated steps are enqueued unless the peek shows the
    loop stopped, so the level counter after the chunk is the JAX chunk's
    ``min(start + chunk, convergence, max_levels)``; the caller's status
    read is the one blocking sync of the chunk."""
    peek = _ConvergencePeek(carry.ctrl, max_levels)
    i = 0
    while chunk is None or i < chunk:
        if peek.stopped():
            break
        step(carry)
        i += 1


def fused_select(f: torch.Tensor, k: int):
    """Selection over the first ``k`` lanes of a padded F vector: the
    alignment-padding lanes hold F = 0 and must never win the tie."""
    lanes = torch.arange(f.shape[0], device=f.device)
    return select_best(f, lanes < k)


def _pack_status(carry: BitCarry, k: int, lane_stride: int = 1) -> torch.Tensor:
    """(4,) int64 [level, updated, minF, minK] — one device buffer, so one
    read serves a chunk's continue-check and the final answer.  Query q's
    F is lane q * ``lane_stride`` of the counters."""
    min_f, min_k = fused_select(carry.f[::lane_stride], k)
    ctrl = carry.ctrl.to(torch.int64)
    return torch.stack([ctrl[1], ctrl[0], min_f, min_k])


class FusedBestEngine(PackedEngineBase):
    """Bit-plane engines whose ``best`` reads the winner from the same
    per-chunk status buffer the level loop already reads.

    Subclasses provide ``_drive(padded, k) -> (carry, status)`` (status is
    the final :func:`_pack_status` as host ints) and ``_warm(padded)``.
    Query q's counters are lane q * ``lane_stride`` of the carry's: 1 for
    bit planes, 8 for byte planes viewed as words (query q in byte q)."""

    k_align = WORD_BITS
    lane_stride = 1

    def _drive(self, queries, k):  # pragma: no cover - interface
        raise NotImplementedError

    def _warm(self, queries) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def best(self, queries) -> Tuple[int, int]:
        padded, k = self._pad_queries(queries)
        _, status = self._drive(padded, k)
        return status[2], status[3]

    def f_values(self, queries) -> torch.Tensor:
        padded, k = self._pad_queries(queries)
        carry, _ = self._drive(padded, k)
        return carry.f[:: self.lane_stride][:k]

    def query_stats(self, queries):
        padded, k = self._pad_queries(queries)
        carry, _ = self._drive(padded, k)
        stride = self.lane_stride
        return (
            carry.levels[::stride][:k].cpu().numpy(),
            carry.reached[::stride][:k].cpu().numpy(),
            carry.f[::stride][:k].cpu().numpy(),
        )

    def compile(self, queries_shape) -> None:
        """Build and load the kernels and warm the level loop (``_warm``)
        at this batch shape, so both land in the preprocessing span."""
        padded, _ = self._pad_queries(np.full(queries_shape, -1, dtype=np.int32))
        self._warm(padded)


def bell_hits_or(frontier: torch.Tensor, graph, slot_budget=None) -> torch.Tensor:
    """(n, W) frontier planes -> (n, W) per-vertex hit planes over a
    BellGraph: the plain forest with the width axis OR-folded (ungated)."""
    from .bell import forest_hits  # lazy: bell imports this module

    return forest_hits(frontier, graph, slot_budget)


def bitbell_switch(graph, sparse_budget: int, width: int) -> Optional[PushSwitch]:
    """A batch's direction switch on the bitbell route at ``width`` words
    a row, or None when every level pulls (no budget, or no non-empty
    dedup CSR): the JAX predicate ``active rows <= budget and their edges
    <= budget``."""
    budget = int(sparse_budget)
    if not budget or graph.sparse is None or graph.sparse[2].shape[0] == 0:
        return None
    return PushSwitch.new(graph.sparse[1], budget, budget, width)


def bitbell_expand(graph, slot_budget=None, plain: bool = False):
    """The expansion of one bitbell level, as ``expand(carry, hits,
    max_levels, scratch)`` filling ``hits`` from ``carry.frontier``.

    Hybrid when the carry has a switch (:func:`bitbell_switch`): the push
    (into the switch's plane) and the forest each run only in the
    direction the previous level's apply wrote into ctrl[3].  Otherwise
    ctrl[3] stays :data:`DIR_PULL` and every level is a forest pull.
    ``plain`` runs the kernels' plain versions."""
    from .cuda_bell import forest_or, forest_or_plain  # lazy: cuda_bell imports this module

    forest = forest_or_plain if plain else forest_or
    push = sparse_hits_or_plain if plain else sparse_hits_or

    def expand(carry: BitCarry, hits: torch.Tensor, max_levels: int, scratch) -> None:
        sw = carry.switch
        if sw is not None:
            start, _, vals = graph.sparse
            push(carry.frontier, start, vals, sw.hits, carry.ctrl, sw, max_levels)
        forest(carry.frontier, graph, hits, carry.ctrl, max_levels, slot_budget, scratch)

    return expand


class BitBellEngine(FusedBestEngine):
    """The default route: bit-plane all-queries-at-once BFS over a
    BellGraph (the JAX package's BitBellEngine).

    ``sparse_budget``: push threshold in active rows and edges (None: auto
    :func:`default_sparse_budget` when the graph kept its dedup CSR; 0:
    pure forest pulls).  ``level_chunk`` / ``megachunk``: levels between
    host syncs (:func:`resolve_megachunk`).  ``slot_budget``: the plain
    forest's gather-segment budget (None: ``MSBFS_SLOT_BUDGET``, else auto
    against the device memory; 0 never segments); the forest kernel
    materialises no gather, so it only changes the plain version's
    memory.  ``plain`` runs every kernel's plain torch version (the
    reference, on any device)."""

    def __init__(
        self,
        graph,
        max_levels: Optional[int] = None,
        sparse_budget: Optional[int] = None,
        level_chunk: Optional[int] = None,
        slot_budget: Optional[int] = None,
        megachunk: Optional[int] = None,
        plain: bool = False,
    ):
        self.graph = graph
        self.device = graph.device
        self.max_levels = max_levels
        self._max_levels = INT32_MAX if max_levels is None else int(max_levels)
        if sparse_budget is None:
            e = int(graph.sparse[2].shape[0]) if graph.sparse is not None else 0
            sparse_budget = default_sparse_budget(e) if e else 0
        self.sparse_budget = int(sparse_budget)
        self.level_chunk = validate_level_chunk(level_chunk)
        self.megachunk = resolve_megachunk(megachunk, self.level_chunk)
        if slot_budget is None:
            env = knobs.raw("MSBFS_SLOT_BUDGET", "")
            if env:
                try:
                    slot_budget = int(env)
                except ValueError:
                    slot_budget = None
        self._slot_budget_arg = slot_budget
        self._max_level_slots = max((int(f.shape[-1]) for f in graph.level_cols), default=0)
        self.plain = bool(plain)
        self._scratch = {}  # plane width -> the pull kernel's scratch

    def _slot_budget_for(self, w_words: int) -> Optional[int]:
        """Gather-segment budget at W = ``w_words``: auto engages only when
        the largest level's merged gather (slots x W x 4 B) would take more
        than a third of the device memory (the JAX package's rule)."""
        if self._slot_budget_arg is not None:
            return self._slot_budget_arg or None  # 0 -> never segment
        from ..utils.platform import device_hbm_bytes

        hbm = device_hbm_bytes(self.device)
        if self._max_level_slots * 4 * w_words <= hbm // 3:
            return None
        return max(1 << 22, (hbm // 4) // (4 * w_words))

    def _init_carry(self, queries) -> BitCarry:
        pack = pack_queries_plain if self.plain else pack_queries
        frontier0, counts0 = pack(self.graph.n, queries, self.device, self.lane_stride)
        switch = bitbell_switch(self.graph, self.sparse_budget, frontier0.shape[1])
        carry = bit_level_init(frontier0, counts0, switch)
        carry.k = int(queries.shape[0])
        return carry

    def _expand(self, w: int):
        """The level's expansion over planes of ``w`` words a row."""
        return bitbell_expand(self.graph, self._slot_budget_for(w), self.plain)

    def _new_scratch(self, w: int):
        """The pull kernel's scratch for planes of ``w`` words a row."""
        from .cuda_bell import forest_scratch

        return forest_scratch(self.graph, w, self.device)

    def _chunk(self, carry: BitCarry, bound) -> None:
        w = carry.frontier.shape[1]
        expand = self._expand(w)
        scratch = None
        if self.device.type == "cuda" and not self.plain:
            if w not in self._scratch:
                self._scratch[w] = self._new_scratch(w)
            scratch = self._scratch[w]
        hits = torch.empty_like(carry.frontier)
        apply = bit_level_apply_plain if self.plain else bit_level_apply

        def step(c: BitCarry) -> None:
            expand(c, hits, self._max_levels, scratch)
            apply(c, hits, self._max_levels)

        bit_level_chunk(carry, step, bound, self._max_levels)

    def _drive(self, queries, k):
        carry = self._init_carry(queries)
        if not self.level_chunk:
            self._chunk(carry, None)
            status = _pack_status(carry, k, self.lane_stride).tolist()
            record_dispatch()
            return carry, status
        bound = self.level_chunk * self.megachunk
        while True:
            self._chunk(carry, bound)
            # One blocking read per chunk serves the continue-check and,
            # on the last chunk, the answer.
            status = _pack_status(carry, k, self.lane_stride).tolist()
            record_dispatch()
            if not status[1] or status[0] >= self._max_levels:
                break
        return carry, status

    def _warm(self, queries) -> None:
        """Build and load the kernels, then run one real level from one
        source, so module loads and first-call allocations (the forest
        scratch and bucket tables included) land in the preprocessing
        span."""
        if self.device.type == "cuda" and not self.plain:
            kernels.library()
        if self.graph.n:
            queries = queries.copy()
            queries[0, 0] = 0
        carry = self._init_carry(queries)
        self._chunk(carry, 1)
        _pack_status(carry, 0).tolist()
