"""Kernel K12, the weighted route's relaxation pass (``csrc/weighted_relax.cu``),
and its plain torch version.

One pass of delta-stepping (weighted/deltastep.py) over the slots
[lo, hi) of the (u, v, w) slot arrays: every slot whose source row is
active for query k, and whose cost lies on the pass's side of ``delta``
(light: w <= delta, heavy: w > delta), offers ``tent[k, u] + w`` to
``out[k, v]``, which keeps the least offer.  ``out`` starts as a copy of
``tent`` and every candidate is read from ``tent``: the JAX package's
Jacobi pass (weighted/deltastep.py:84 ``_relax_scatter_min``), so each
flavor's improved sets and counters equal JAX's.

:func:`relax` launches the kernel on a CUDA tensor and runs
:func:`relax_plain` only on a CPU tensor; a kernel that fails to build or
launch raises (runtime/kernels.py), with no fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# Unreached sentinel of the tentative planes (weighted/deltastep.py).
INF = 1 << 30

# Candidate cells (queries x slots) the plain version builds at a time: a
# (K, chunk) int32 candidate array and its int64 index, about 0.8 GB.
PLAIN_CHUNK_CELLS = 1 << 26


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
    """The pass the JAX way, in slot chunks: ``cand = where(active[:, u] &
    sel, tent[:, u] + w, INF)``, then a scatter-min of ``cand`` into
    ``out`` (a copy of ``tent`` when not given) at ``v``."""
    if out is None:
        out = tent.clone()
    k = tent.shape[0]
    hi = u.shape[0] if hi is None else hi
    if k == 0 or hi <= lo:
        return out
    step = max(1, chunk_cells // k)
    for s0 in range(lo, hi, step):
        s1 = min(hi, s0 + step)
        uu = u[s0:s1].long()
        ww = w[s0:s1]
        sel = ww <= delta if light else ww > delta
        cand = torch.where(active[:, uu] & sel, tent[:, uu] + ww, INF)
        out.scatter_reduce_(1, v[s0:s1].long().expand(k, -1), cand, "amin")
    return out


def relax(
    tent: torch.Tensor,
    active: torch.Tensor,
    slots: Sequence[torch.Tensor],
    lo: int,
    hi: int,
    delta: int,
    light: bool,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One pass over slots [lo, hi) of ``slots`` = (u, v, w): ``out``
    (``tent``'s copy, made here on the device's stream when not given)
    with the pass's offers committed.  ``tent`` (K, n_state) int32,
    ``active`` (K, n_state) bool, the slot arrays int32, all contiguous on
    one device."""
    u, v, w = slots
    if tent.device.type == "cpu":
        return relax_plain(tent, active, u, v, w, delta, light, lo, hi, out)
    if out is None:
        out = tent.clone()
    k, n_state = tent.shape
    for name, t, dtype in (("tent", tent, torch.int32), ("out", out, torch.int32),
                           ("active", active, torch.bool), ("u", u, torch.int32),
                           ("v", v, torch.int32), ("w", w, torch.int32)):
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
    if not (0 <= lo <= hi <= u.shape[0] == v.shape[0] == w.shape[0]):
        raise ValueError(f"weighted_relax: slots [{lo}, {hi}) outside the slot arrays")
    if k == 0 or hi == lo:
        return out
    from ..runtime import kernels

    kernels.launch(
        "weighted_relax", tent.device, tent.data_ptr(), out.data_ptr(),
        active.data_ptr(), n_state, k, u.data_ptr(), v.data_ptr(), w.data_ptr(),
        lo, hi, int(delta), int(bool(light)),
        variant="light" if light else "heavy",
    )
    return out
