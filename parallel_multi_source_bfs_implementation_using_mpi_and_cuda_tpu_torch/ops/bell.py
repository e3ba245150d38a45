"""The BELL reduction forest in plain torch (the JAX package's ops/bell.py).

Per forest level and bucket (R_b, W_b):

    out_b[r] = OR over j < W_b of  V_prev[cols_b[r, j]]

where V_prev is the frontier (level 0) or the previous level's output,
with a zero sentinel row appended; then per vertex ``H = V_cat[final_slot]``
over the concatenation of all level outputs and a trailing zero row.
torch has no OR reduction, so the width axis is folded with a loop of
``|`` over (n, W) int32 word planes.  This is the plain version of the
``forest_or`` kernel (:mod:`.cuda_bell`).
"""

from __future__ import annotations

from typing import Optional

import torch


def _slot_segments(shapes, slot_budget: int):
    """Partition a level's bucket layout into contiguous segments of at
    most ``slot_budget`` slots: oversized buckets split at row boundaries
    (a row wider than the budget stays whole).  Returns [[(slot_offset,
    rows, width), ...], ...] in layout order."""
    pieces = []
    off = 0
    for r_b, w_b in shapes:
        if r_b == 0:
            continue
        rows_per = max(1, slot_budget // w_b)
        r0 = 0
        while r0 < r_b:
            rc = min(rows_per, r_b - r0)
            pieces.append((off + r0 * w_b, rc, w_b))
            r0 += rc
        off += r_b * w_b
    segments, cur, cur_slots = [], [], 0
    for p in pieces:
        s = p[1] * p[2]
        if cur and cur_slots + s > slot_budget:
            segments.append(cur)
            cur, cur_slots = [], 0
        cur.append(p)
        cur_slots += s
    if cur:
        segments.append(cur)
    return segments


def _or_rows(g: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """(rows * width, C) gathered words -> (rows, C): OR over each row's
    ``width`` consecutive entries."""
    g = g.view(rows, width, -1)
    out = g[:, 0].clone()
    for j in range(1, width):
        out |= g[:, j]
    return out


def forest_hits(frontier: torch.Tensor, graph, slot_budget: Optional[int] = None) -> torch.Tensor:
    """(n, C) frontier words (zero = not in the frontier) -> (n, C)
    per-vertex hit words over a BellGraph.  ``slot_budget`` gathers a
    level whose slot count exceeds it in contiguous segments of at most
    that many slots, each reduced before the next is gathered (the JAX
    package's bound on the live gather intermediate); the result is the
    same either way."""
    c = frontier.shape[1]
    zero_row = frontier.new_zeros((1, c))
    v_prev = torch.cat([frontier, zero_row])  # sentinel row n
    outs = []
    for flat, shapes in zip(graph.level_cols, graph.level_shapes):
        if flat.shape[-1] == 0:
            out = frontier.new_zeros((0, c))
        elif slot_budget is None or flat.shape[-1] <= slot_budget:
            g = v_prev[flat.long()]
            parts, off = [], 0
            for r_b, w_b in shapes:
                if r_b == 0:
                    continue
                parts.append(_or_rows(g[off : off + r_b * w_b], r_b, w_b))
                off += r_b * w_b
            out = torch.cat(parts)
        else:
            parts = []
            for pieces in _slot_segments(shapes, slot_budget):
                a = pieces[0][0]
                b = pieces[-1][0] + pieces[-1][1] * pieces[-1][2]
                g = v_prev[flat[a:b].long()]
                o = 0
                for _, rc, w_b in pieces:
                    parts.append(_or_rows(g[o : o + rc * w_b], rc, w_b))
                    o += rc * w_b
            out = torch.cat(parts)
        outs.append(out)
        v_prev = torch.cat([out, zero_row])
    v_cat = torch.cat(outs + [zero_row])
    return v_cat[graph.final_slot.long()]
