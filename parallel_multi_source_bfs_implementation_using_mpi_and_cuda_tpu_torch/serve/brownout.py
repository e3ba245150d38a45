"""Brownout ladder: graceful quality degradation under sustained
saturation (the JAX package's docs/SERVING.md "Autoscaling & overload";
this is its serve/brownout.py, copied: the same ticks give the same rungs
and journal lines).

When the fleet is saturated faster than the autoscaler can add capacity
— or the churn budget is spent — the remaining lever is *quality*: the
optional integrity work (voting, audits) costs real
throughput (cross-replica voting doubles a sampled query, output audits
recompute BFS on the host), and a stampede is exactly when that
headroom buys the most.  The ladder steps those knobs down one rung at
a time, and back up when the storm passes:

====  ============  ====================================================
rung  name          what is given up
====  ============  ====================================================
0     ``full``      nothing — voting and audits at their configured rates
1     ``no-vote``   cross-replica voting suspended (router-local)
2     ``no-audit``  per-replica output certification sampled to 0
                    (pushed to replicas via the ``posture`` verb)
3     ``cache-only``  batch-priority queries are answered only from the
                    result cache: a repeat query still gets its (cached,
                    previously certified) answer, a fresh batch query is
                    shed typed.  Interactive traffic still computes.
====  ============  ====================================================

The ordering is deliberate: each rung sheds integrity *redundancy*
before anyone's *answers* degrade — voting guards against a lying
replica (rarest), audits against silent corruption (rare), and only the
last rung touches user-visible behavior, for the cheapest class only.

Like the autoscaler this is a pure controller: ``tick(saturated)`` once
per heartbeat, hysteresis both directions (``down_after`` consecutive
saturated ticks to step down, ``up_after`` clear ticks to step up, plus
a ``min_dwell`` so a rung is never left within the same breath it was
entered).  Every transition is appended to a bounded in-memory log that
``stats`` surfaces, and — when a ``journal_path`` is given — to an
append-only JSONL journal, so a post-incident review can replay exactly
when quality was degraded and why.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Deque, List, Optional, Tuple

RUNGS = ("full", "no-vote", "no-audit", "cache-only")


class BrownoutLadder:
    """Pure saturation -> quality-rung controller.  ``level`` indexes
    :data:`RUNGS`; helpers expose the per-rung effects the serving
    layers consult (:meth:`vote_suppressed`, :meth:`audit_suppressed`,
    :meth:`cache_only`)."""

    def __init__(self, down_after: int = 3, up_after: int = 6,
                 min_dwell: int = 4, log_cap: int = 64,
                 journal_path: Optional[str] = None):
        for name, v in (("down_after", down_after), ("up_after", up_after)):
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if min_dwell < 0:
            raise ValueError(f"min_dwell must be >= 0, got {min_dwell}")
        self.down_after = int(down_after)
        self.up_after = int(up_after)
        self.min_dwell = int(min_dwell)
        self.journal_path = journal_path
        self.level = 0
        self.tick_index = 0
        self.entered_at = 0  # tick the current rung was entered
        self.saturated_ticks = 0
        self.clear_ticks = 0
        self.steps_down = 0
        self.steps_up = 0
        self.transitions: Deque[dict] = deque(maxlen=int(log_cap))

    # ---- rung effects (consulted by router/frontend/server) -----------
    @property
    def rung(self) -> str:
        return RUNGS[self.level]

    def vote_suppressed(self) -> bool:
        return self.level >= 1

    def audit_suppressed(self) -> bool:
        return self.level >= 2

    def cache_only(self) -> bool:
        return self.level >= 3

    # ---- the control loop --------------------------------------------
    def tick(self, saturated: bool) -> Optional[Tuple[str, str]]:
        """One heartbeat of saturation signal.  Returns ``(from, to)``
        rung names when this tick crossed a rung boundary, else None —
        the caller applies the effects (suppress votes, push posture)
        exactly when a transition is reported."""
        self.tick_index += 1
        if saturated:
            self.saturated_ticks += 1
            self.clear_ticks = 0
        else:
            self.clear_ticks += 1
            self.saturated_ticks = 0
        dwelt = self.tick_index - self.entered_at >= self.min_dwell
        if (saturated and dwelt and self.level < len(RUNGS) - 1
                and self.saturated_ticks >= self.down_after):
            return self._step(+1)
        if (not saturated and dwelt and self.level > 0
                and self.clear_ticks >= self.up_after):
            return self._step(-1)
        return None

    def _step(self, direction: int) -> Tuple[str, str]:
        old = self.rung
        self.level += direction
        new = self.rung
        self.entered_at = self.tick_index
        self.saturated_ticks = 0
        self.clear_ticks = 0
        if direction > 0:
            self.steps_down += 1
        else:
            self.steps_up += 1
        entry = {"tick": self.tick_index, "from": old, "to": new}
        self.transitions.append(entry)
        self._journal(entry)
        return (old, new)

    def _journal(self, entry: dict) -> None:
        """Best-effort append-only JSONL record of the transition.  A
        failed write never blocks the control loop — the in-memory log
        in ``stats`` is the primary record, the file is forensics."""
        if not self.journal_path:
            return
        try:
            with open(self.journal_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(entry, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass

    def describe(self) -> dict:
        """Current rung + bounded transition history for ``stats``."""
        return {
            "rung": self.rung,
            "level": self.level,
            "tick": self.tick_index,
            "saturated_ticks": self.saturated_ticks,
            "clear_ticks": self.clear_ticks,
            "steps_down": self.steps_down,
            "steps_up": self.steps_up,
            "down_after": self.down_after,
            "up_after": self.up_after,
            "min_dwell": self.min_dwell,
            "transitions": list(self.transitions),
        }


def effects_for(level: int) -> List[str]:
    """Human-readable effect list for a rung level (docs/CLI)."""
    out = []
    if level >= 1:
        out.append("cross-replica voting suspended")
    if level >= 2:
        out.append("output audit sampling -> 0")
    if level >= 3:
        out.append("batch queries served from result cache only")
    return out
