"""Kernel K12, the weighted route's relaxation pass (``csrc/weighted_relax.cu``),
and its plain torch version.

One pass of delta-stepping (weighted/deltastep.py) over one side of the
slots: every slot (u, v, w) whose source row is active for query k, and
whose cost lies on the pass's side of ``delta`` (light: w <= delta, heavy:
w > delta), offers ``tent[u, k] + w`` to ``out[v, k]``, which keeps the
least offer.  The planes are query-minor, (n_state, K): a row's K queries
are contiguous.  ``out`` starts as a copy of ``tent`` and every candidate
is read from ``tent``: the JAX package's Jacobi pass
(weighted/deltastep.py:84 ``_relax_scatter_min``, on the transposed
planes), so each flavor's improved sets and counters equal JAX's.

The engine keeps each side's slots apart (:class:`RelaxSide`), in row
order, cut into pieces of at most :data:`PIECE_SLOTS` slots of one row
(:func:`..models.csr.row_pieces`); a pass hands K12 a run of pieces.

:func:`relax` launches the kernel on a CUDA tensor and runs
:func:`relax_plain` only on a CPU tensor; a kernel that fails to build or
launch raises (runtime/kernels.py), with no fallback.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.csr import row_pieces

# Unreached sentinel of the tentative planes (weighted/deltastep.py).
INF = 1 << 30

# Candidate cells (slots x queries) the plain version builds at a time: a
# (chunk, K) int32 candidate array and its int64 index, about 0.8 GB.
PLAIN_CHUNK_CELLS = 1 << 26

# Slots of one row a piece holds at most: a lane group walks a piece.
PIECE_SLOTS = 64


class RelaxSide(NamedTuple):
    """One side (light or heavy) of the slots, on the engine's device: the
    (u, v, w) int32 slot arrays (u only for the plain version) and the
    (R, 3) int32 (start, end, owner) pieces the kernel walks, and the
    pieces on the host (``host_pieces``: slot ranges and owners without a
    device read)."""

    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor
    pieces: torch.Tensor
    host_pieces: np.ndarray

    @property
    def num_pieces(self) -> int:
        return int(self.host_pieces.shape[0])

    def slot_range(self, p0: int, p1: int) -> Tuple[int, int]:
        """The slots of pieces [p0, p1): one contiguous range."""
        if p1 <= p0:
            return 0, 0
        return int(self.host_pieces[p0, 0]), int(self.host_pieces[p1 - 1, 1])


def make_side(u, v, w, device, cuts=None, piece_slots: int = PIECE_SLOTS,
              native: bool = True) -> RelaxSide:
    """A :class:`RelaxSide` from host slot arrays whose rows ``u`` come in
    runs (sorted, or sorted within each segment starting at a ``cuts``
    position)."""
    pieces = row_pieces(u, piece_slots, cuts, native)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)

    return RelaxSide(up(u), up(v), up(w), up(pieces), pieces)


def relax_plan(k: int, aligned: bool) -> Tuple[int, int]:
    """(vec, group): the kernel's queries a lane reads in one access (4,
    16 bytes of int32, where every row of the planes starts 16-byte
    aligned: K % 4 == 0 and aligned bases; else 1) and the lanes that walk
    one piece: the power of two that covers K / vec, at most a warp.  A
    wider K loops over its queries a group's width at a time."""
    vec = 4 if aligned and k % 4 == 0 else 1
    need = -(-max(k, 1) // vec)
    group = 1
    while group < need and group < 32:
        group *= 2
    return vec, group


def relax_plain(
    tent: torch.Tensor,
    active: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    delta: int,
    light: bool,
    lo: int = 0,
    hi: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
    chunk_cells: int = PLAIN_CHUNK_CELLS,
) -> torch.Tensor:
    """The pass the JAX way on query-minor planes, over slots [lo, hi) in
    chunks: ``cand = where(active[u] & sel, tent[u] + w, INF)``, then a
    scatter-min of ``cand`` into ``out`` (a copy of ``tent`` when not
    given) along the vertex axis at ``v``."""
    if out is None:
        out = tent.clone()
    k = tent.shape[1]
    hi = u.shape[0] if hi is None else hi
    if k == 0 or hi <= lo:
        return out
    step = max(1, chunk_cells // k)
    for s0 in range(lo, hi, step):
        s1 = min(hi, s0 + step)
        uu = u[s0:s1].long()
        ww = w[s0:s1, None]
        sel = ww <= delta if light else ww > delta
        cand = torch.where(active[uu] & sel, tent[uu] + ww, INF)
        out.scatter_reduce_(0, v[s0:s1, None].long().expand(-1, k), cand, "amin")
    return out


def relax(
    tent: torch.Tensor,
    active: torch.Tensor,
    side: RelaxSide,
    p0: int,
    p1: int,
    delta: int,
    light: bool,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One pass over pieces [p0, p1) of ``side`` (the light side when
    ``light``): ``out`` (``tent``'s copy, made here on the device's stream
    when not given) with the pass's offers committed.  ``tent`` (n_state,
    K) int32, ``active`` (n_state, K) bool, the side's arrays int32, all
    contiguous on one device."""
    if tent.device.type == "cpu":
        s0, s1 = side.slot_range(p0, p1)
        return relax_plain(tent, active, side.u, side.v, side.w, delta, light, s0, s1, out)
    if out is None:
        out = tent.clone()
    k = tent.shape[1]
    for name, t, dtype in (("tent", tent, torch.int32), ("out", out, torch.int32),
                           ("active", active, torch.bool), ("v", side.v, torch.int32),
                           ("w", side.w, torch.int32), ("pieces", side.pieces, torch.int32)):
        if t.device != tent.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"weighted_relax: {name} must be a contiguous {dtype} tensor on "
                f"{tent.device}, got {t.dtype} on {t.device}"
            )
    if out.shape != tent.shape or active.shape != tent.shape:
        raise ValueError(
            f"weighted_relax: tent {tuple(tent.shape)}, out {tuple(out.shape)} and "
            f"active {tuple(active.shape)} must match"
        )
    if not 0 <= p0 <= p1 <= side.num_pieces == side.pieces.shape[0]:
        raise ValueError(f"weighted_relax: pieces [{p0}, {p1}) outside the piece table")
    if k == 0 or p1 == p0:
        return out
    aligned = tent.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 \
        and active.data_ptr() % 4 == 0
    vec, group = relax_plan(k, aligned)
    from ..runtime import kernels

    kernels.launch(
        "weighted_relax", tent.device, tent.data_ptr(), out.data_ptr(),
        active.data_ptr(), k, side.pieces.data_ptr(), side.v.data_ptr(),
        side.w.data_ptr(), p0, p1, vec, group,
        variant="light" if light else "heavy",
    )
    return out
