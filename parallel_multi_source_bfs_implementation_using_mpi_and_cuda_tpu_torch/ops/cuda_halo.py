"""The halo exchange of the vertex-sharded engines as hand-written CUDA
kernels (``csrc/halo_exchange.cu``): H1 ``halo_pair_or``, H2
``halo_push_match`` and ``halo_push_or`` and H3 ``owner_push_expand``;
and :class:`ScanScratch`, the status words of the ordered compaction that
H2's match, H3 and M2 ``wire_encode`` share (``csrc/ordered_scan.cuh``).

Counterparts of three XLA chains of the JAX package, each an OR built
from byte lanes and a scatter-max: parallel/sharded_bell.py
``rebuild_planes`` and push_sharded.py's landing of the boundary pairs at
their owner (H1, whose segmented form also decodes the 2D mesh's sparse
wire: parallel/partition2d.py), sharded_bell.py ``_push_own_hits`` (H2), and
push_sharded.py ``_push_level`` (H3).  Beside each kernel is its plain
torch version, the same function in those byte lanes; a wrapper takes
the plain version for CPU tensors and launches the kernel for CUDA ones
(a failed build or launch raises).

Planes and words are int32 tensors read as uint32 (query 32w + b in bit b
of word w), pair ids int32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..runtime import kernels
from .bfs import INT32_MAX
from .bitbell import _check_device, level_go, pack_byte_planes, unpack_byte_planes


# Words before the tiles' status words in a scan scratch, and the epochs a
# scratch runs through before it is zeroed (csrc/ordered_scan.cuh kHeader,
# kEpochs).
SCAN_HEADER = 2
SCAN_EPOCHS = 1 << 30
# Slots a tile of H3 takes, pairs a tile of H2's match
# (csrc/halo_exchange.cu kExpandTile, kMatchTile).
EXPAND_TILE = 512
MATCH_TILE = 1024


class ScanScratch:
    """The status words of the ordered compaction that H3 and M2 share
    (``csrc/ordered_scan.cuh``): a ticket, the finalizer's published
    slot, and two words a tile, int64, zeroed once when made.  Every
    launch on it takes a new epoch (:meth:`next_epoch`), so words an
    earlier launch left read as unpublished and no launch clears them; the
    words are zeroed again only before the epoch wraps.  Launches on one
    scratch must be ordered (one stream)."""

    def __init__(self, tiles: int, device):
        self.words = torch.zeros(SCAN_HEADER + 2 * max(int(tiles), 1), dtype=torch.int64,
                                 device=device)
        self.epoch = 0

    @property
    def tiles(self) -> int:
        """The most tiles a launch on this scratch may have."""
        return (self.words.numel() - SCAN_HEADER) // 2

    def next_epoch(self) -> int:
        self.epoch += 1
        if self.epoch >= SCAN_EPOCHS:
            self.words.zero_()
            self.epoch = 1
        return self.epoch


# (device index, stream) -> the scratch of launches given none.
_SCRATCH: Dict[Tuple[int, int], ScanScratch] = {}


def scan_scratch(dev: torch.device, tiles: int, scratch: Optional[ScanScratch] = None
                 ) -> ScanScratch:
    """``scratch`` checked to hold ``tiles`` on ``dev``, or, when None, the
    scratch kept for ``dev``'s current stream (grown as needed)."""
    if scratch is not None:
        if scratch.words.device != dev or scratch.tiles < tiles:
            raise ValueError(f"a scan scratch of {scratch.tiles} tiles on "
                             f"{scratch.words.device}; the launch needs {tiles} on {dev}")
        return scratch
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           torch.cuda.current_stream(dev).cuda_stream)
    held = _SCRATCH.get(key)
    if held is None or held.tiles < tiles:
        held = _SCRATCH[key] = ScanScratch(max(tiles, 2 * (held.tiles if held else 0)), dev)
    return held


def expand_tiles(capacity: int, width: int) -> int:
    """H3's most tiles for a queue of ``capacity`` rows of ``width`` slots."""
    return -(-int(capacity) * int(width) // EXPAND_TILE)


def _or_rows(plane: torch.Tensor, rows: torch.Tensor, words: torch.Tensor) -> None:
    """plane[rows[i]] |= words[i] for every i, duplicates allowed: the byte
    lanes' sum, > 0, packed (the JAX chains' scatter-max on 0/1 bytes)."""
    if not rows.numel():
        return
    acc = torch.zeros((plane.shape[0], plane.shape[1] * 32), dtype=torch.int32,
                      device=plane.device)
    acc.index_add_(0, rows, unpack_byte_planes(words).to(torch.int32))
    plane |= pack_byte_planes((acc > 0).to(torch.uint8))


def _check(name: str, t: torch.Tensor, dtype=torch.int32, dim=None) -> None:
    if t.dtype != dtype or not t.is_contiguous() or (dim is not None and t.dim() != dim):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor"
                         + ("" if dim is None else f" of rank {dim}"))


def halo_pair_or_plain(ids, words, plane, lo: int = 0, ctrl=None, max_levels=INT32_MAX):
    """H1's function in torch: plane[ids[i] - lo] |= words[i] for each pair
    whose row falls in [0, rows) (the sentinel drops); gated on ``ctrl``
    when given."""
    if ctrl is not None and not level_go(ctrl, max_levels):
        return
    r = ids.to(torch.int64) - int(lo)
    ok = (r >= 0) & (r < plane.shape[0])
    _or_rows(plane, r[ok], words[ok])


# The most segments one H1 launch lands (csrc/halo_exchange.cu kMaxSegments).
MAX_SEGMENTS = 16


class Segment(NamedTuple):
    """One pair list of H1's segmented form: pair i lands in plane row
    ``base + ids[i] - lo`` when ``0 <= ids[i] - lo < rows``, else drops."""

    ids: torch.Tensor
    words: torch.Tensor
    base: int
    rows: int
    lo: int = 0


def halo_pair_or_segments_plain(segments, plane, ctrl=None, max_levels=INT32_MAX) -> None:
    """The segmented form's function in torch: each segment's pairs
    outside its rows dropped, the rest rebased to its base (JAX's
    rebasing with its sentinels re-clamped), all landed by one OR."""
    if ctrl is not None and not level_go(ctrl, max_levels):
        return
    rows, words = [], []
    for s in segments:
        r = s.ids.to(torch.int64) - int(s.lo)
        ok = (r >= 0) & (r < int(s.rows))
        rows.append(r[ok] + int(s.base))
        words.append(s.words[ok])
    if rows:
        _or_rows(plane, torch.cat(rows), torch.cat(words))


def _check_segments(segments, plane, ctrl) -> torch.device:
    """Every segment's pair list and rows checked against ``plane``; their
    common device."""
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"an H1 launch lands 1 to {MAX_SEGMENTS} segments, got {len(segments)}")
    _check("plane", plane, dim=2)
    rows, w = plane.shape
    for s in segments:
        _check("ids", s.ids, dim=1)
        _check("words", s.words, dim=2)
        if tuple(s.words.shape) != (s.ids.shape[0], w):
            raise ValueError(f"words must be ({s.ids.shape[0]}, {w})")
        if s.base < 0 or s.rows < 0 or s.base + s.rows > rows:
            raise ValueError(f"segment rows [{s.base}, {s.base + s.rows}) outside the "
                             f"plane's {rows}")
    extra = () if ctrl is None else (ctrl,)
    return _check_device(*(t for s in segments for t in (s.ids, s.words)), plane, *extra)


def _launch_pair_or(dev, segments, plane, ctrl, max_levels, variant: str = "") -> None:
    table = (ctypes.c_longlong * (6 * len(segments)))(*(
        x for s in segments for x in (s.ids.data_ptr(), s.words.data_ptr(),
                                      int(s.ids.shape[0]), int(s.lo), int(s.base),
                                      int(s.rows))))
    kernels.launch("halo_pair_or", dev, table, len(segments), plane.shape[1],
                   plane.data_ptr(), None if ctrl is None else ctrl.data_ptr(),
                   int(max_levels), variant=variant)


def halo_pair_or(ids: torch.Tensor, words: torch.Tensor, plane: torch.Tensor,
                 lo: int = 0, ctrl=None, max_levels: int = INT32_MAX) -> None:
    """Kernel H1 (``csrc/halo_exchange.cu``): land gathered (row, words)
    pairs in ``plane`` (rows, W) by OR, rows offset by ``lo``; duplicate
    rows are allowed and rows outside the plane drop.  Gated on the device
    control ``ctrl`` when given (``level_go``)."""
    segment = Segment(ids, words, 0, plane.shape[0], int(lo))
    dev = _check_segments([segment], plane, ctrl)
    if dev.type == "cpu":
        halo_pair_or_plain(ids, words, plane, lo, ctrl, max_levels)
        return
    _launch_pair_or(dev, [segment], plane, ctrl, max_levels)


def halo_pair_or_segments(segments, plane: torch.Tensor, ctrl=None,
                          max_levels: int = INT32_MAX) -> None:
    """Kernel H1's segmented form: up to :data:`MAX_SEGMENTS` pair lists
    (:class:`Segment`) landed in ``plane`` (rows, W) by OR in one launch
    (variant ``seg``), each inside its own rows, so that no segment's
    sentinel reaches the next segment's rows; duplicates OR together,
    within a segment and across segments.  Gated like :func:`halo_pair_or`."""
    segments = list(segments)
    dev = _check_segments(segments, plane, ctrl)
    if dev.type == "cpu":
        halo_pair_or_segments_plain(segments, plane, ctrl, max_levels)
        return
    _launch_pair_or(dev, segments, plane, ctrl, max_levels, variant="seg")


class PushMatch(NamedTuple):
    """H2's match of gathered pairs against one shard's push CSR: each
    pair's first edge slot ``st`` and in-block degree ``deg`` (0 where its
    id is no source of the CSR, the sentinel included), ``pos`` the
    exclusive prefix of deg (the pair's first edge in the flat edge space;
    int32 (pairs,) each) and ``total`` the pairs' in-block edges (a (1,)
    int64)."""

    st: torch.Tensor
    deg: torch.Tensor
    pos: torch.Tensor
    total: torch.Tensor


def _check_csr(csr) -> None:
    for name, t in zip(("src_ids", "src_start", "src_cnt", "vals"), csr):
        _check(name, t, dim=1)


def halo_push_match_plain(ids, csr) -> PushMatch:
    """H2's match in torch, as the JAX package decides the route
    (parallel/sharded_bell.py ``searchsorted`` of the ids in the sources,
    ``deg``/``st`` where they match, their int64 sum)."""
    src_ids, src_start, src_cnt, _ = csr
    m, pairs = src_ids.shape[0], ids.shape[0]
    if m == 0:
        deg = st = torch.zeros(pairs, dtype=torch.int32, device=ids.device)
    else:
        at = torch.clamp(torch.searchsorted(src_ids, ids), max=m - 1)
        match = src_ids[at] == ids
        deg = torch.where(match, src_cnt[at], 0).to(torch.int32)
        st = torch.where(match, src_start[at], 0).to(torch.int32)
    ends = torch.cumsum(deg.to(torch.int64), 0)
    total = ends[-1:] if pairs else torch.zeros(1, dtype=torch.int64, device=ids.device)
    return PushMatch(st, deg, (ends - deg).to(torch.int32), total.clone())


def halo_push_match(ids: torch.Tensor, csr, scratch: Optional[ScanScratch] = None
                    ) -> PushMatch:
    """H2's match (kernel ``halo_push_match``, ``csrc/halo_exchange.cu``):
    each gathered pair's id found among the sources of one shard's push CSR
    (``parallel/sharded_bell.py`` ``build_push_halo``) — see
    :class:`PushMatch`.  One launch; the total is the route decision's
    input.  The pairs' ids must be distinct but for the sentinel (each
    shard's own rows), so that the edges stay below 2^31.  ``scratch``: a
    :class:`ScanScratch` of at least ceil(pairs / :data:`MATCH_TILE`)
    tiles on the ids' device (None: one kept per stream)."""
    _check("ids", ids, dim=1)
    _check_csr(csr)
    src_ids, src_start, src_cnt, _ = csr
    dev = _check_device(ids, src_ids, src_start, src_cnt)
    if dev.type == "cpu":
        return halo_push_match_plain(ids, csr)
    pairs = ids.shape[0]
    scratch = scan_scratch(dev, max(1, -(-pairs // MATCH_TILE)), scratch)
    out = PushMatch(*(torch.empty(pairs, dtype=torch.int32, device=dev) for _ in range(3)),
                    torch.empty(1, dtype=torch.int64, device=dev))
    kernels.launch("halo_push_match", dev, ids.data_ptr(), pairs, src_ids.data_ptr(),
                   src_start.data_ptr(), src_cnt.data_ptr(), int(src_ids.shape[0]),
                   out.st.data_ptr(), out.deg.data_ptr(), out.pos.data_ptr(),
                   out.total.data_ptr(), scratch.words.data_ptr(), scratch.next_epoch())
    return out


def halo_push_or_plain(ids, words, csr, hits, match: Optional[PushMatch] = None) -> None:
    """H2's function in torch: each pair whose id is a source of the
    in-block push CSR ``csr`` = (src_ids ascending, src_start, src_cnt,
    vals) ORs its words into ``hits`` at every block-local neighbour; the
    edges spread flat by the match's prefix (``match``: the pairs'
    :class:`PushMatch`, made here when None)."""
    if match is None:
        match = halo_push_match_plain(ids, csr)
    vals = csr[3]
    deg = match.deg.to(torch.int64)
    owner = torch.repeat_interleave(torch.arange(ids.shape[0], device=ids.device), deg)
    within = torch.arange(owner.shape[0], device=ids.device) - torch.repeat_interleave(
        match.pos.to(torch.int64), deg)
    nbr = vals[match.st.to(torch.int64)[owner] + within].to(torch.int64)
    ok = (nbr >= 0) & (nbr < hits.shape[0])
    _or_rows(hits, nbr[ok], words[owner[ok]])


def halo_push_or(ids: torch.Tensor, words: torch.Tensor, csr, hits: torch.Tensor,
                 match: Optional[PushMatch] = None, edges: Optional[int] = None) -> None:
    """Kernel H2 (``csrc/halo_exchange.cu``): the in-block push of the
    gathered (global id, words) pairs through one shard's push CSR
    (``parallel/sharded_bell.py`` ``build_push_halo``) into its own
    (block, W) hit rows, by OR; a pair whose id has no in-block edge adds
    nothing.  ``match``: the pairs' :class:`PushMatch` (None: one
    :func:`halo_push_match` launch first); then one launch, a thread an
    edge.  ``edges``: the match's total as the host read it, which sizes
    the grid (None: read here)."""
    block, w = hits.shape
    _check("ids", ids, dim=1)
    _check("words", words, dim=2)
    _check("hits", hits, dim=2)
    _check_csr(csr)
    if tuple(words.shape) != (ids.shape[0], w):
        raise ValueError(f"words must be ({ids.shape[0]}, {w})")
    if match is not None:
        for name, t in zip(("st", "deg", "pos"), match[:3]):
            _check(name, t, dim=1)
            if t.shape[0] != ids.shape[0]:
                raise ValueError(f"the match's {name} has {t.shape[0]} pairs, not {ids.shape[0]}")
        _check("total", match.total, dtype=torch.int64, dim=1)
    dev = _check_device(ids, words, hits, *csr, *(() if match is None else match))
    if dev.type == "cpu":
        halo_push_or_plain(ids, words, csr, hits, match)
        return
    if match is None:
        match = halo_push_match(ids, csr)
    if edges is None:
        edges = int(match.total[0])
    kernels.launch(
        "halo_push_or", dev, words.data_ptr(), int(ids.shape[0]), w, match.st.data_ptr(),
        match.pos.data_ptr(), match.total.data_ptr(), int(edges), csr[3].data_ptr(),
        hits.data_ptr(), block,
    )


def owner_push_expand_plain(table, queue, count, frontier, hits, lo: int, n_pad: int,
                            bnd_ids, bnd_words, bcount, peak, ctrl,
                            max_levels: int = INT32_MAX) -> None:
    """H3's function in torch, in JAX's slot order: for the first
    min(count, capacity) queued rows u and each column d of u's table row
    (slot i * width + d), a neighbour inside the block ORs u's words into
    its hit row, one outside it (and not the sentinel ``n_pad``) is a
    boundary slot; the first ``bnd`` boundary slots become (dst, words)
    pairs, the rest (n_pad, 0); ``bcount`` their number in full and
    ``peak`` its running maximum.  Gated on ``ctrl``."""
    if not level_go(ctrl, max_levels):
        return
    block, width = frontier.shape[0], table.shape[1]
    listed = min(int(count[0]), queue.shape[0])
    u = queue[:listed].to(torch.int64)
    v = table[u].reshape(-1).to(torch.int64)
    src = u.repeat_interleave(width)
    local = v - int(lo)
    inside = (v < n_pad) & (local >= 0) & (local < block)
    _or_rows(hits, local[inside], frontier[src[inside]])
    border = torch.nonzero((v < n_pad) & ~inside, as_tuple=True)[0]
    total = int(border.shape[0])
    kept = border[: bnd_ids.shape[0]]
    bnd_ids.fill_(int(n_pad))
    bnd_words.zero_()
    bnd_ids[: kept.shape[0]] = v[kept].to(torch.int32)
    bnd_words[: kept.shape[0]] = frontier[src[kept]]
    bcount.fill_(total)
    torch.maximum(peak, bcount, out=peak)


def owner_push_expand(table: torch.Tensor, queue: torch.Tensor, count: torch.Tensor,
                      frontier: torch.Tensor, hits: torch.Tensor, lo: int, n_pad: int,
                      bnd_ids: torch.Tensor, bnd_words: torch.Tensor,
                      bcount: torch.Tensor, peak: torch.Tensor, ctrl: torch.Tensor,
                      max_levels: int = INT32_MAX,
                      scratch: Optional[ScanScratch] = None) -> None:
    """Kernel H3 (``csrc/halo_exchange.cu``): one owner-partitioned push
    level of one shard — see :func:`owner_push_expand_plain` for the
    function.  ``table`` (block + 1, width) int32 global ids (row block
    all sentinel), ``queue`` (capacity,) and ``count`` (1,) the own
    frontier's row queue (K11's row mode), ``frontier`` and ``hits``
    (block, W), ``bnd_ids`` (bnd,), ``bnd_words`` (bnd, W), ``bcount``
    and ``peak`` (1,) int32; gated on ``ctrl``.  ``scratch``: a
    :class:`ScanScratch` of at least :func:`expand_tiles` (capacity,
    width) tiles on the shard's device (None: one kept per stream)."""
    block, w = frontier.shape
    for name, t, dim in (("table", table, 2), ("queue", queue, 1), ("count", count, 1),
                         ("frontier", frontier, 2), ("hits", hits, 2),
                         ("bnd_ids", bnd_ids, 1), ("bnd_words", bnd_words, 2),
                         ("bcount", bcount, 1), ("peak", peak, 1), ("ctrl", ctrl, 1)):
        _check(name, t, dim=dim)
    if table.shape[0] != block + 1 or tuple(hits.shape) != (block, w):
        raise ValueError(f"table must be ({block + 1}, width), hits ({block}, {w})")
    if tuple(bnd_words.shape) != (bnd_ids.shape[0], w):
        raise ValueError(f"bnd_words must be ({bnd_ids.shape[0]}, {w})")
    dev = _check_device(table, queue, count, frontier, hits, bnd_ids, bnd_words,
                        bcount, peak, ctrl)
    if dev.type == "cpu":
        owner_push_expand_plain(table, queue, count, frontier, hits, lo, n_pad, bnd_ids,
                                bnd_words, bcount, peak, ctrl, max_levels)
        return
    scratch = scan_scratch(dev, expand_tiles(queue.shape[0], table.shape[1]), scratch)
    kernels.launch(
        "owner_push_expand", dev, table.data_ptr(), int(table.shape[1]), queue.data_ptr(),
        int(queue.shape[0]), count.data_ptr(), frontier.data_ptr(), w, hits.data_ptr(),
        block, int(lo), int(n_pad), bnd_ids.data_ptr(), bnd_words.data_ptr(),
        int(bnd_ids.shape[0]), bcount.data_ptr(), peak.data_ptr(), ctrl.data_ptr(),
        int(max_levels), scratch.words.data_ptr(), scratch.next_epoch(),
    )


def pair_words(frontier: torch.Tensor, ids: torch.Tensor, listed: torch.Tensor,
               lo: int, sentinel: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sparse halo's send buffers from a row queue: (global ids, words)
    of the first ``listed`` queued rows (``ids`` block-local, ascending),
    ``sentinel`` and zero words past them (JAX's ``compact_frontier_planes``
    with the shard's offset applied).  Device ops only."""
    slot = torch.arange(ids.shape[0], device=ids.device, dtype=torch.int32)
    valid = slot < listed
    safe = torch.where(valid, ids, 0).to(torch.int64)
    gids = torch.where(valid, ids + int(lo), int(sentinel)).to(torch.int32)
    words = torch.where(valid[:, None], frontier.index_select(0, safe), 0)
    return gids.contiguous(), words.contiguous()
