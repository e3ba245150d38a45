"""The ``MSBFS_STATS`` tables, on stderr (stdout stays reference-exact).

The port's copy of the JAX package's utils/trace.py formatters:
:func:`format_query_stats` (``MSBFS_STATS=1``: levels run, vertices
reached and F per query) and :func:`format_level_stats` (``=2``: the
stepped per-level trace).  The profiler trace of the computation span
(``MSBFS_PROFILE_DIR``) is not ported yet; the CLI refuses the knob.
"""

from __future__ import annotations

from typing import Sequence


def format_level_stats(level_counts, level_seconds) -> str:
    """Per-level trace table: one line per executed BFS level with the
    vertices discovered at that distance (summed over queries), the
    queries still active, and the level's wall time.  Row 0 is the
    source packing (distance-0 vertices)."""
    lines = ["level  discovered  active_queries  seconds"]
    for d, (counts, sec) in enumerate(zip(level_counts, level_seconds)):
        total = int(sum(int(c) for c in counts))
        active = int(sum(1 for c in counts if int(c) > 0))
        lines.append(f"{d:5d}  {total:10d}  {active:14d}  {float(sec):.6f}")
    return "\n".join(lines) + "\n"


def format_query_stats(
    levels: Sequence[int], reached: Sequence[int], f_values: Sequence[int]
) -> str:
    """Per-query stats table, one line per query, 1-based ids as in the
    report (main.cu:409)."""
    lines = ["query  levels  reached  F"]
    for i, (lv, rc, fv) in enumerate(zip(levels, reached, f_values)):
        lines.append(f"{i + 1:5d}  {int(lv):6d}  {int(rc):7d}  {int(fv)}")
    return "\n".join(lines) + "\n"
