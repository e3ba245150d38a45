"""The 2D mesh engine's kernels (parallel/partition2d.py) as hand-written
CUDA: M1 ``chunk_merge`` and M2 ``wire_encode`` (``csrc/mesh_wire.cu``),
M4 ``forest_max`` and its commit form ``forest_max_commit``
(``csrc/forest_max.cu``); the sparse wire's decode is H1
``halo_pair_or`` (:func:`wire_decode`; a gather's segments in one launch
of its segmented form, :func:`wire_decode_segments`).

Counterparts of the JAX package's XLA chains: the col-axis
reduce-scatter's combine under OR (bit planes) and MAX (the async drive's
int32 neg-distance planes) with ``neg_commit`` fused behind it and the
next local wave's send (``neg_relax_chunk``'s ``where(delta, merged, 0)``)
written in the same launch (M1), ``active_word_count`` with
``encode_words_sparse`` (M2), and the async drive's forest max-fold with
``_async_cand`` fused into its first level's reads, whole (the forest's
levels, the last with the final take by ``final_slot`` in its launch), one
streamed segment at a time, or, for a local wave, with the shard's own
rows committed in the last level's launch and no hit row written (M4).
Beside each kernel is its plain torch version; a wrapper takes the plain
version for CPU tensors and launches the kernel for CUDA ones (a failed
build or launch raises).

Planes are int32 tensors (bit planes read as uint32, neg planes as
int32); delta and changed masks are ``torch.bool`` (one byte each).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from ..runtime import kernels
from .bell import _max_rows, forest_hits, segment_fold
from .bitbell import DIR_PULL, INT32_MAX, NEG_BASE, _check_device, _check_plane, direction_go
from .cuda_bell import SegmentTables, forest_scratch
from .cuda_halo import (
    MAX_SEGMENTS,
    ScanScratch,
    Segment,
    halo_pair_or,
    halo_pair_or_segments,
    scan_scratch,
)

# The most chunks one merge takes (csrc/mesh_wire.cu kMaxChunks): a col
# axis of at most this many shards.
MAX_CHUNKS = 16
# Words a tile of the encoder takes (csrc/mesh_wire.cu kEncodeTile).
ENCODE_TILE = 2048
# Lanes of a word the encoder counts: the word, or its four byte lanes.
WORD_LANES, BYTE_LANES = 1, 4
_OPS = {"or": 0, "max": 1}


class Commit(NamedTuple):
    """The async drive's commit (``csrc/neg_commit.cuh``; M1's epilogue,
    MAX only, and M4's commit form): ``neg`` updated in place to max(neg,
    cand), ``delta`` written cand > neg, ``acc`` (or None) ORed with delta
    (set to it with ``acc_set``), ``flag`` (a (1,) int32, or None) set to
    ``tag`` when some delta is set, and ``send`` (an int32 plane of neg's
    size, or None) written delta ? cand : 0, the next local wave's rows."""

    neg: torch.Tensor
    delta: torch.Tensor
    acc: Optional[torch.Tensor] = None
    flag: Optional[torch.Tensor] = None
    send: Optional[torch.Tensor] = None
    acc_set: bool = False
    tag: int = 1

    def tensors(self):
        """Its tensors (None where absent), in field order."""
        return (self.neg, self.delta, self.acc, self.flag, self.send)

    def clone(self) -> "Commit":
        """A copy whose tensors are fresh copies."""
        return self._replace(**{k: None if t is None else t.clone()
                                for k, t in zip(self._fields, self.tensors())})


def _check_parts(parts: Sequence[torch.Tensor]) -> int:
    if not 1 <= len(parts) <= MAX_CHUNKS:
        raise ValueError(f"a merge takes 1 to {MAX_CHUNKS} chunks, got {len(parts)}")
    words = parts[0].numel()
    for p in parts:
        _check_plane("chunk", p)
        if p.numel() != words:
            raise ValueError("chunks of a merge must have equal sizes")
    return words


def _check_mask(name: str, t: torch.Tensor, words: int) -> None:
    if t.dtype != torch.bool or not t.is_contiguous() or t.numel() != words:
        raise ValueError(f"{name} must be a contiguous bool tensor of {words} elements")


def commit_plain(cand: torch.Tensor, commit: Commit) -> None:
    """The commit's function in torch (JAX's ``neg_commit``, then
    ``jnp.where(delta, merged, 0)`` for the send)."""
    neg = commit.neg
    v = cand.reshape(neg.shape)
    d = v > neg
    neg.copy_(torch.maximum(neg, v))
    commit.delta.copy_(d.view(commit.delta.shape))
    if commit.acc is not None:
        if commit.acc_set:
            commit.acc.copy_(d.view(commit.acc.shape))
        else:
            commit.acc.logical_or_(d.view(commit.acc.shape))
    if commit.send is not None:
        commit.send.copy_(torch.where(d, v, torch.zeros_like(v)).view(commit.send.shape))
    if commit.flag is not None and bool(d.any()):
        commit.flag.fill_(int(commit.tag))


def chunk_merge_plain(parts, out=None, op: str = "or", commit: Optional[Commit] = None) -> None:
    """M1's function in torch: the chunks folded by ``op`` into ``out``,
    or committed (:func:`commit_plain`)."""
    v = parts[0].clone()
    for p in parts[1:]:
        if op == "or":
            v |= p
        else:
            v = torch.maximum(v, p)
    if commit is None:
        out.copy_(v.view(out.shape))
        return
    commit_plain(v, commit)


def _check_commit(commit: Commit, words: int) -> list:
    """The commit's planes checked against ``words`` lanes; its tensors."""
    _check_plane("neg", commit.neg)
    if commit.neg.numel() != words:
        raise ValueError(f"neg has {commit.neg.numel()} elements, the rows {words}")
    _check_mask("delta", commit.delta, words)
    if commit.acc is not None:
        _check_mask("acc", commit.acc, words)
    if commit.flag is not None:
        _check_plane("flag", commit.flag, (1,))
    if commit.send is not None:
        _check_plane("send", commit.send)
        if commit.send.numel() != words:
            raise ValueError(f"send has {commit.send.numel()} elements, the rows {words}")
    return [t for t in commit.tensors() if t is not None]


def _commit_args(commit: Commit) -> tuple:
    """The commit's pointers and modes in the C entries' order: neg, delta,
    acc, acc_set, flag, tag, send."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    return (commit.neg.data_ptr(), commit.delta.data_ptr(), ptr(commit.acc),
            int(bool(commit.acc_set)), ptr(commit.flag), int(commit.tag), ptr(commit.send))


def chunk_merge(
    parts: Sequence[torch.Tensor],
    out: Optional[torch.Tensor] = None,
    op: str = "or",
    commit: Optional[Commit] = None,
) -> None:
    """Kernel M1 (``csrc/mesh_wire.cu``): the elementwise OR or MAX of
    ``parts`` (contiguous int32 chunks of one size, at most
    :data:`MAX_CHUNKS`) into ``out``, or with ``commit`` (MAX only) into
    the neg plane it names (:class:`Commit`; variant ``max/commit``, or
    ``max/commit/send`` when it writes a send)."""
    if op not in _OPS:
        raise ValueError(f"unknown merge op {op!r}")
    words = _check_parts(parts)
    extra = []
    if commit is None:
        if out is None:
            raise ValueError("a merge without a commit needs ``out``")
        _check_plane("out", out)
        if out.numel() != words:
            raise ValueError(f"out has {out.numel()} elements, the chunks {words}")
        extra.append(out)
    else:
        if op != "max":
            raise ValueError("the commit epilogue merges by max")
        extra += _check_commit(commit, words)
    dev = _check_device(*parts, *extra)
    if dev.type == "cpu":
        chunk_merge_plain(parts, out, op, commit)
        return
    ptrs = (ctypes.c_longlong * len(parts))(*(p.data_ptr() for p in parts))
    if commit is None:
        tail = (out.data_ptr(), None, None, None, None, 0, 1, None)
        variant = op
    else:
        neg, delta, acc, acc_set, flag, tag, send = _commit_args(commit)
        tail = (None, neg, delta, acc, flag, acc_set, tag, send)
        variant = "max/commit" + ("/send" if commit.send is not None else "")
    kernels.launch("chunk_merge", dev, ptrs, len(parts), words, _OPS[op], *tail,
                   variant=variant)


class Encoded(NamedTuple):
    """M2's outputs: the plane's nonzero elements (a (1,) int64, whole
    even when the list is cut), the first ``budget`` flat indices of its
    nonzero words (ascending, sentinel = the plane's words) and those
    words (0 at sentinels)."""

    count: torch.Tensor
    idx: torch.Tensor
    words: torch.Tensor


def encode_tiles(total: int) -> int:
    """The encoder's tiles for a plane of ``total`` words: what its
    :class:`~.cuda_halo.ScanScratch` must hold."""
    return -(-int(total) // ENCODE_TILE)


def wire_encode_plain(plane, budget: int, lanes: int = WORD_LANES) -> Encoded:
    """M2's function in torch."""
    flat = plane.reshape(-1)
    total = flat.numel()
    nz = flat != 0
    if lanes == BYTE_LANES:
        count = (flat.view(torch.uint8) != 0).sum(dtype=torch.int64)
    else:
        count = nz.sum(dtype=torch.int64)
    ids = torch.nonzero(nz).flatten()[:budget]
    idx = torch.full((budget,), total, dtype=torch.int32, device=flat.device)
    words = torch.zeros(budget, dtype=torch.int32, device=flat.device)
    idx[: ids.numel()] = ids.to(torch.int32)
    words[: ids.numel()] = flat[ids]
    return Encoded(count.view(1), idx, words)


def wire_encode(plane: torch.Tensor, budget: int, lanes: int = WORD_LANES,
                scratch: Optional[ScanScratch] = None) -> Encoded:
    """Kernel M2 (``csrc/mesh_wire.cu``): the sparse wire's encoding of a
    contiguous int32 plane (:class:`Encoded`); ``lanes`` =
    :data:`BYTE_LANES` counts the nonzero bytes of a byte-lane plane
    instead of its nonzero words.  The list is exact iff the count is at
    most ``budget``.  One launch.  ``scratch``: a
    :class:`~.cuda_halo.ScanScratch` of at least :func:`encode_tiles`
    tiles on the plane's device (None: one kept per stream)."""
    _check_plane("plane", plane)
    total = plane.numel()
    if total < 1 or total >= 2**31:
        raise ValueError(f"a plane of {total} words: the encoder takes 1 to 2^31 - 1")
    if budget < 1:
        raise ValueError(f"the sparse wire's budget must be positive, got {budget}")
    if lanes not in (WORD_LANES, BYTE_LANES):
        raise ValueError(f"lanes must be {WORD_LANES} or {BYTE_LANES}")
    dev = _check_device(plane)
    if dev.type == "cpu":
        return wire_encode_plain(plane, budget, lanes)
    scratch = scan_scratch(dev, encode_tiles(total), scratch)
    out = Encoded(torch.empty(1, dtype=torch.int64, device=dev),
                  torch.empty(budget, dtype=torch.int32, device=dev),
                  torch.empty(budget, dtype=torch.int32, device=dev))
    kernels.launch("wire_encode", dev, plane.data_ptr(), total, lanes, int(budget),
                   out.idx.data_ptr(), out.words.data_ptr(), out.count.data_ptr(),
                   scratch.words.data_ptr(), scratch.next_epoch(),
                   variant="bytes" if lanes == BYTE_LANES else "words")
    return out


def wire_decode(idx: torch.Tensor, words: torch.Tensor, plane: torch.Tensor) -> None:
    """The sparse wire's decode (the JAX package's ``decode_words_sparse``)
    into the zeroed contiguous int32 ``plane``: H1 ``halo_pair_or`` over
    its flat words as one-word rows (the sentinel falls outside them)."""
    halo_pair_or(idx, words.view(-1, 1), plane.view(-1, 1))


def wire_decode_segments(pairs, plane: torch.Tensor, total: int) -> None:
    """Several sparse wire encodings of ``total``-word planes decoded into
    the contiguous int32 ``plane`` by OR, each at its own flat word offset:
    ``pairs`` = [(idx, words, base), ...].  H1's segmented form, one launch
    a :data:`~.cuda_halo.MAX_SEGMENTS` segments; each encoding's sentinel
    (``total``) drops inside its own segment, so none lands on the next
    one's first word (the aliasing JAX's ``_sparse_row_gather`` re-clamps).
    Onto zeros with unique indices this is one ``index_put_`` of the
    rebased pairs; overlapping segments OR together."""
    flat = plane.view(-1, 1)
    segments = [Segment(idx, words.view(-1, 1), int(base), int(total))
                for idx, words, base in pairs]
    for at in range(0, len(segments), MAX_SEGMENTS):
        halo_pair_or_segments(segments[at : at + MAX_SEGMENTS], flat)


def cand_floor(max_levels: Optional[int]) -> int:
    """The candidate step's horizon as the kernel takes it: a candidate
    below it is zeroed (0 without a horizon)."""
    return 0 if max_levels is None else max(0, NEG_BASE - int(max_levels))


def forest_max_plain(prev, prev_rows, cols, pieces, out, floor: Optional[int] = None) -> None:
    """M4's function in torch: :func:`.bell.segment_fold` by max over
    ``prev`` (its zero sentinel row at ``prev_rows``), the candidate step
    applied to every value read when ``floor`` is not None."""
    v = prev[:prev_rows]
    if floor is not None:
        v = _cand(v, floor)
    v_prev = torch.cat([v, v.new_zeros((1, prev.shape[1]))])
    out.copy_(segment_fold(v_prev, cols, pieces, _max_rows))


def _cand(v: torch.Tensor, floor: int) -> torch.Tensor:
    c = torch.clamp(v - 1, min=0)
    return torch.where(c >= floor, c, torch.zeros_like(c))


def _vec16(w: int, *tensors: Optional[torch.Tensor]) -> bool:
    """M4 reads rows as 16-byte vectors: W a multiple of 4 and every plane
    16-byte aligned (csrc/forest_max.cu)."""
    return w % 4 == 0 and all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def forest_max(
    prev: torch.Tensor,
    prev_rows: int,
    cols: torch.Tensor,
    tables: SegmentTables,
    i: int,
    out: torch.Tensor,
    floor: Optional[int] = None,
) -> None:
    """Kernel M4 (``csrc/forest_max.cu``), one forest level or streamed
    segment ``i`` of ``tables``: out[r] = max over each piece's width of
    prev[cols[...]] (int32 lanes, a slot equal to ``prev_rows`` reading 0),
    every value read first taken through the async drive's candidate step
    when ``floor`` (:func:`cand_floor`) is given.  Ungated."""
    pieces = tables.pieces[i]
    w = prev.shape[1]
    slots = sum(r * c for r, c in pieces)
    rows = sum(r for r, _ in pieces)
    _check_plane("prev", prev)
    _check_plane("cols", cols)
    _check_plane("out", out, (rows, w))
    if prev.dim() != 2 or prev.shape[0] < prev_rows:
        raise ValueError(f"prev must be (>= {prev_rows}, {w})")
    if cols.dim() != 1 or cols.shape[0] < slots:
        raise ValueError(f"cols must be 1-D with at least {slots} slots")
    dev = _check_device(prev, cols, out)
    if dev.type == "cpu":
        forest_max_plain(prev, prev_rows, cols[:slots], pieces, out, floor)
        return
    if not rows:
        return
    if tables.device != dev:
        raise ValueError(f"segment tables on {tables.device}, planes on {dev}")
    table, buckets, _ = tables.entry(i, 2)
    kernels.launch("forest_max", dev, prev.data_ptr(), int(prev_rows), cols.data_ptr(), table,
                   buckets, rows, out.data_ptr(), w, int(floor is not None),
                   0 if floor is None else int(floor), int(_vec16(w, prev, out)),
                   None, None, 0, 0, None, INT32_MAX,
                   variant="cand" if floor is not None else "max")


def forest_max_take_plain(prev, prev_rows, cols, pieces, scratch, last_off: int, final_slot,
                          hits, ctrl, floor: Optional[int] = None) -> None:
    """The take form's function in torch: the last forest level folded as
    :func:`forest_max_plain` folds it, then hits[v] = the row final_slot[v]
    of (the scratch's first ``last_off`` rows, that level, a zero row);
    gated like K1s's final take."""
    if not direction_go(ctrl, INT32_MAX, DIR_PULL):
        return
    w = hits.shape[1]
    rows = sum(r for r, _ in pieces)
    last = hits.new_zeros((rows, w))
    if rows:
        forest_max_plain(prev, prev_rows, cols[: sum(r * c for r, c in pieces)], pieces, last,
                         floor)
    earlier = scratch[:last_off] if last_off else hits.new_zeros((0, w))
    hits.copy_(torch.cat([earlier, last, hits.new_zeros((1, w))])[final_slot.long()])


def forest_max_take(
    prev: torch.Tensor,
    prev_rows: int,
    cols: torch.Tensor,
    tables: SegmentTables,
    i: int,
    scratch: Optional[torch.Tensor],
    last_off: int,
    final_slot: torch.Tensor,
    hits: torch.Tensor,
    go: torch.Tensor,
    floor: Optional[int] = None,
) -> None:
    """M4's take form (variant ``cand/take`` or ``max/take``): the forest's
    last level ``i`` of ``tables`` folded in the final row order straight
    into ``hits`` (n, W): hits[v] is the fold of level row final_slot[v] -
    ``last_off``, a copy of ``scratch`` row final_slot[v] when that is
    below ``last_off`` (an earlier level's row), or 0 at the sentinel (the
    forest's row count).  One launch, gated on ``go`` as K1s's
    ``forest_gather`` is."""
    pieces = tables.pieces[i]
    n, w = hits.shape
    slots = sum(r * c for r, c in pieces)
    rows = sum(r for r, _ in pieces)
    _check_plane("prev", prev)
    _check_plane("cols", cols)
    _check_plane("hits", hits)
    _check_plane("final_slot", final_slot, (n,))
    _check_plane("go", go, (4,))
    if prev.dim() != 2 or prev.shape[0] < prev_rows or prev.shape[1] != w:
        raise ValueError(f"prev must be (>= {prev_rows}, {w})")
    if cols.dim() != 1 or cols.shape[0] < slots:
        raise ValueError(f"cols must be 1-D with at least {slots} slots")
    if last_off:
        _check_plane("scratch", scratch)
        if scratch.dim() != 2 or scratch.shape[0] < last_off or scratch.shape[1] != w:
            raise ValueError(f"scratch must be (>= {last_off}, {w})")
    tensors = (prev, cols, hits, final_slot, go) + ((scratch,) if last_off else ())
    dev = _check_device(*tensors)
    if dev.type == "cpu":
        forest_max_take_plain(prev, prev_rows, cols, pieces, scratch, last_off, final_slot, hits,
                              go, floor)
        return
    if not n:
        return
    if tables.device != dev:
        raise ValueError(f"segment tables on {tables.device}, planes on {dev}")
    table, buckets, _ = tables.entry(i, 2)
    kept = scratch if last_off else None
    kernels.launch("forest_max", dev, prev.data_ptr(), int(prev_rows), cols.data_ptr(), table,
                   buckets, n, hits.data_ptr(), w, int(floor is not None),
                   0 if floor is None else int(floor), int(_vec16(w, prev, hits, kept)),
                   final_slot.data_ptr(), None if kept is None else kept.data_ptr(),
                   int(last_off), int(last_off) + rows, go.data_ptr(), INT32_MAX,
                   variant=("cand" if floor is not None else "max") + "/take")


def forest_max_commit_plain(prev, prev_rows, cols, pieces, scratch, last_off: int, final_slot,
                            row0: int, commit: Commit, ctrl, floor: Optional[int] = None) -> None:
    """The commit form's function in torch: :func:`forest_max_take_plain`
    into a scratch hit plane, then its rows [row0, row0 + rows) committed
    (:func:`commit_plain`: ``neg_commit`` and the send's ``where``); gated
    like the take."""
    if not direction_go(ctrl, INT32_MAX, DIR_PULL):
        return
    rows = commit.neg.shape[0]
    w = commit.neg.shape[1]
    hits = commit.neg.new_zeros((final_slot.shape[0], w))
    forest_max_take_plain(prev, prev_rows, cols, pieces, scratch, last_off, final_slot, hits,
                          ctrl, floor)
    commit_plain(hits[row0 : row0 + rows], commit)


def forest_max_commit(
    prev: torch.Tensor,
    prev_rows: int,
    cols: torch.Tensor,
    tables: SegmentTables,
    i: int,
    scratch: Optional[torch.Tensor],
    last_off: int,
    final_slot: torch.Tensor,
    row0: int,
    commit: Commit,
    go: torch.Tensor,
    floor: Optional[int] = None,
) -> None:
    """M4's commit form (kernel ``forest_max_commit``, variant
    ``cand/commit`` or ``max/commit``): the take form of the forest's last
    level ``i`` restricted to final rows [row0, row0 + rows), rows =
    ``commit.neg``'s, each folded row committed into ``commit``'s (rows, W)
    planes (:class:`Commit`: neg, delta, acc, the next wave's send, the
    flag set to its tag) and no hit row written.  One launch, gated on
    ``go`` as the take."""
    pieces = tables.pieces[i]
    if commit.neg.dim() != 2:
        raise ValueError("the commit's neg plane must be (rows, W)")
    rows, w = commit.neg.shape
    slots = sum(r * c for r, c in pieces)
    level_rows = sum(r for r, _ in pieces)
    _check_plane("prev", prev)
    _check_plane("cols", cols)
    _check_plane("final_slot", final_slot)
    _check_plane("go", go, (4,))
    extra = _check_commit(commit, rows * w)
    if final_slot.dim() != 1 or not 0 <= row0 <= final_slot.shape[0] - rows:
        raise ValueError(f"rows [{row0}, {row0 + rows}) outside the {final_slot.shape[0]} "
                         "final rows")
    if prev.dim() != 2 or prev.shape[0] < prev_rows or prev.shape[1] != w:
        raise ValueError(f"prev must be (>= {prev_rows}, {w})")
    if cols.dim() != 1 or cols.shape[0] < slots:
        raise ValueError(f"cols must be 1-D with at least {slots} slots")
    if last_off:
        _check_plane("scratch", scratch)
        if scratch.dim() != 2 or scratch.shape[0] < last_off or scratch.shape[1] != w:
            raise ValueError(f"scratch must be (>= {last_off}, {w})")
    tensors = (prev, cols, final_slot, go, *extra) + ((scratch,) if last_off else ())
    dev = _check_device(*tensors)
    if dev.type == "cpu":
        forest_max_commit_plain(prev, prev_rows, cols, pieces, scratch, last_off, final_slot,
                                row0, commit, go, floor)
        return
    if not rows:
        return
    if tables.device != dev:
        raise ValueError(f"segment tables on {tables.device}, planes on {dev}")
    table, buckets, _ = tables.entry(i, 2)
    kept = scratch if last_off else None
    vec = _vec16(w, prev, kept, commit.neg, commit.send) and all(
        t is None or t.data_ptr() % 4 == 0 for t in (commit.delta, commit.acc))
    neg, delta, acc, acc_set, flag, tag, send = _commit_args(commit)
    kernels.launch("forest_max_commit", dev, prev.data_ptr(), int(prev_rows), cols.data_ptr(),
                   table, buckets, w, int(floor is not None), 0 if floor is None else int(floor),
                   int(vec), final_slot.data_ptr(), None if kept is None else kept.data_ptr(),
                   int(last_off), int(last_off) + level_rows, go.data_ptr(), INT32_MAX,
                   int(row0), rows, neg, delta, acc, acc_set, flag, tag, send,
                   variant=("cand" if floor is not None else "max") + "/commit")


def level_tables(graph, device) -> SegmentTables:
    """A device BellGraph's forest levels as M4's tables (one segment a
    level, its non-empty buckets), built once per graph and device."""
    key = ("forest_max", str(device))
    if key not in graph._kernel_tables:
        pieces = [tuple((r, w) for r, w in shapes if r) for shapes in graph.level_shapes]
        graph._kernel_tables[key] = SegmentTables(
            pieces, None if torch.device(device).type == "cpu" else device)
    return graph._kernel_tables[key]


def forest_max_hits_plain(frontier, graph, hits, floor: int) -> None:
    """The whole-forest form's function in torch, as the JAX package
    computes it: the forest max-fold, then the candidate step."""
    hits.copy_(_cand(forest_hits(frontier, graph, reduce=_max_rows), floor))


def forest_max_hits(
    frontier: torch.Tensor,
    graph,
    hits: torch.Tensor,
    floor: int,
    go: torch.Tensor,
    scratch: Optional[torch.Tensor] = None,
) -> None:
    """M4's whole-forest form: the candidate maxima of ``frontier`` (n, W)
    int32 lanes over a device BellGraph into ``hits`` (n, W): a launch a
    forest level but the last into ``scratch`` (the candidate step in the
    first level's reads), then the last level and the final take by
    ``final_slot`` in one launch (:func:`forest_max_take`, gated on ``go``,
    a control that lets it run): a one-level forest is one launch.  Each
    launch's plain version on CPU tensors, which together are
    :func:`forest_max_hits_plain`.  ``scratch``:
    :func:`.cuda_bell.forest_scratch`'s (needed only below the last level)."""
    n, w = frontier.shape
    _check_plane("frontier", frontier, (graph.n, w))
    _check_plane("hits", hits, (graph.n, w))
    dev = _check_device(frontier, hits, go)
    tables = level_tables(graph, dev)
    last = len(graph.level_cols) - 1
    if scratch is None and last > 0:
        scratch = forest_scratch(graph, w, dev)
    if scratch is not None:
        _check_plane("scratch", scratch, (graph.total_rows + 1, w))
    offset, prev, prev_rows = 0, frontier, graph.n
    for li in range(last):
        size = graph.level_sizes[li]
        out = scratch[offset : offset + size]
        if size:
            forest_max(prev, prev_rows, graph.level_cols[li], tables, li, out,
                       floor if li == 0 else None)
        prev, prev_rows = out, size
        offset += size
    forest_max_take(prev, prev_rows, graph.level_cols[last], tables, last, scratch, offset,
                    graph.final_slot, hits, go, floor if last == 0 else None)


def forest_max_hits_commit(
    frontier: torch.Tensor,
    graph,
    row0: int,
    commit: Commit,
    floor: int,
    go: torch.Tensor,
    scratch: Optional[torch.Tensor] = None,
) -> None:
    """M4's whole-forest commit form, a local wave of the async drive: the
    candidate maxima of ``frontier`` (n, W) over a device BellGraph, as
    :func:`forest_max_hits` computes them, but only hit rows [row0, row0 +
    rows) and those committed (:class:`Commit`, rows = its neg plane's):
    a launch a forest level but the last into ``scratch``, then the last
    level's own rows committed in one launch (:func:`forest_max_commit`),
    so a one-level forest is one launch.  Each launch's plain version on
    CPU tensors."""
    n, w = frontier.shape
    _check_plane("frontier", frontier, (graph.n, w))
    dev = _check_device(frontier, go)
    tables = level_tables(graph, dev)
    last = len(graph.level_cols) - 1
    if scratch is None and last > 0:
        scratch = forest_scratch(graph, w, dev)
    if scratch is not None:
        _check_plane("scratch", scratch, (graph.total_rows + 1, w))
    offset, prev, prev_rows = 0, frontier, graph.n
    for li in range(last):
        size = graph.level_sizes[li]
        out = scratch[offset : offset + size]
        if size:
            forest_max(prev, prev_rows, graph.level_cols[li], tables, li, out,
                       floor if li == 0 else None)
        prev, prev_rows = out, size
        offset += size
    forest_max_commit(prev, prev_rows, graph.level_cols[last], tables, last, scratch, offset,
                      graph.final_slot, row0, commit, go, floor if last == 0 else None)


def go_control(device) -> torch.Tensor:
    """A level control that lets every gated launch run: updated, level 0,
    the pull direction."""
    return torch.tensor([1, 0, 0, 0], dtype=torch.int32, device=device)
