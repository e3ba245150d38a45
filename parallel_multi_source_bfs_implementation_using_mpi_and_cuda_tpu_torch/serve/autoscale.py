"""Elastic fleet autoscaling policy (the JAX package's docs/SERVING.md
"Autoscaling & overload"; this is its serve/autoscale.py, copied: the
same signals give the same decisions).

A pure decision object: signals in, ``+k`` / ``-k`` / ``0`` out, no
threads, no sockets, no clocks.  The fleet supervisor feeds it one tick
per heartbeat from the signals the ``health`` verb already carries
(queue depth/capacity, oldest queued age) plus the shed counters from
``stats``.  Its decisions are a function of the signal sequence alone,
so a test can hold them against the JAX package's policy tick by tick.

Three stabilizers keep the loop from flapping, each a knob:

hysteresis
    A scale decision needs ``up_after`` (resp. ``down_after``)
    *consecutive* hot (cold) ticks.  One hot heartbeat is noise; a
    stampede is hot on every tick.  ``down_after`` defaults much larger
    than ``up_after`` — adding capacity late costs latency, removing it
    early costs a re-add (and a reshard) when the load returns.

cooldown
    After any scale event the policy holds for ``cooldown_ticks`` ticks
    regardless of signals, long enough for the event's effect (a new
    replica warming, a victim draining) to show up in the signals it
    watches — the classic control-loop settle time.

churn budget
    At most ``churn_budget`` membership changes per ``churn_window``
    ticks, full stop.  A pathological signal (e.g. a flapping replica
    oscillating the mean) can exhaust the budget but never thrash the
    ring faster than graphs can reshard.

A tick is **hot** when mean queue utilization >= ``high_watermark``, or
anything was shed since the last tick, or the oldest queued request is
older than ``age_high_s`` — any one signal suffices, because each names
a different failure (full queues, admission collapse, a stuck head).
A tick is **cold** only when utilization <= ``low_watermark`` AND
nothing was shed AND the queue head is young: scale-down needs every
signal quiet.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional, Sequence


@dataclass
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    high_watermark: float = 0.75  # mean depth/capacity that reads as hot
    low_watermark: float = 0.15   # mean depth/capacity that reads as cold
    age_high_s: float = 1.0       # oldest queued request age that reads hot
    up_after: int = 2             # consecutive hot ticks before scale-up
    down_after: int = 8           # consecutive cold ticks before scale-down
    cooldown_ticks: int = 6       # post-event hold, either direction
    max_step: int = 1             # replicas added/removed per event
    churn_budget: int = 4         # membership changes allowed ...
    churn_window: int = 120       # ... per this many ticks

    def validate(self) -> "AutoscaleConfig":
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}"
            )
        if not (0.0 <= self.low_watermark < self.high_watermark):
            raise ValueError(
                f"need 0 <= low_watermark < high_watermark, got "
                f"{self.low_watermark} / {self.high_watermark}"
            )
        for name in ("up_after", "down_after", "max_step", "churn_budget"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        return self


@dataclass
class ReplicaSignal:
    """One replica's slice of the fleet signal, as the supervisor reads
    it off the ``health`` verb.  ``utilization`` is queue depth over
    capacity (>= 0, may exceed 1 transiently); ``oldest_age_s`` is the
    monotonic age of the queue head (0 when empty)."""

    utilization: float = 0.0
    oldest_age_s: float = 0.0


class AutoscalePolicy:
    """Feed :meth:`tick` once per heartbeat; it returns the signed
    replica delta to apply (0 = hold).  The caller owns actually adding
    or removing replicas — and reports the applied change back via the
    return-value contract (a non-zero decision assumes it was applied;
    call :meth:`cancel` if it was not, to refund the churn budget)."""

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = (config or AutoscaleConfig()).validate()
        self.tick_index = 0
        self.hot_ticks = 0
        self.cold_ticks = 0
        self.cooldown_until = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_decision = 0
        self.last_reason = "init"
        self._events: Deque[int] = deque()  # tick index of each event

    # ---- signal classification ---------------------------------------
    def _classify(self, replicas: Sequence[ReplicaSignal],
                  shed_since_last: int) -> str:
        cfg = self.config
        if not replicas:
            return "hot"  # an empty fleet is maximally under-provisioned
        util = sum(r.utilization for r in replicas) / len(replicas)
        age = max(r.oldest_age_s for r in replicas)
        if (util >= cfg.high_watermark or shed_since_last > 0
                or age >= cfg.age_high_s):
            return "hot"
        if util <= cfg.low_watermark and shed_since_last == 0 \
                and age < cfg.age_high_s:
            return "cold"
        return "warm"

    def _churn_left(self) -> int:
        cfg = self.config
        floor = self.tick_index - cfg.churn_window
        while self._events and self._events[0] <= floor:
            self._events.popleft()
        return cfg.churn_budget - len(self._events)

    # ---- the control loop --------------------------------------------
    def tick(self, size: int, replicas: Sequence[ReplicaSignal],
             shed_since_last: int = 0) -> int:
        """One heartbeat: classify signals, update hysteresis counters,
        return the replica delta (+k to add, -k to remove, 0 to hold).
        ``size`` is the current replica count the delta applies to."""
        cfg = self.config
        self.tick_index += 1
        state = self._classify(replicas, shed_since_last)
        if state == "hot":
            self.hot_ticks += 1
            self.cold_ticks = 0
        elif state == "cold":
            self.cold_ticks += 1
            self.hot_ticks = 0
        else:
            self.hot_ticks = 0
            self.cold_ticks = 0
        if self.tick_index < self.cooldown_until:
            self.last_decision, self.last_reason = 0, "cooldown"
            return 0
        if self.hot_ticks >= cfg.up_after and size < cfg.max_replicas:
            if self._churn_left() < 1:
                self.last_decision, self.last_reason = 0, "churn-budget"
                return 0
            delta = min(cfg.max_step, cfg.max_replicas - size)
            self._commit(delta, "hot")
            return delta
        if self.cold_ticks >= cfg.down_after and size > cfg.min_replicas:
            if self._churn_left() < 1:
                self.last_decision, self.last_reason = 0, "churn-budget"
                return 0
            delta = -min(cfg.max_step, size - cfg.min_replicas)
            self._commit(delta, "cold")
            return delta
        self.last_decision, self.last_reason = 0, state
        return 0

    def _commit(self, delta: int, reason: str) -> None:
        self.hot_ticks = 0
        self.cold_ticks = 0
        self.cooldown_until = self.tick_index + self.config.cooldown_ticks
        self._events.append(self.tick_index)
        if delta > 0:
            self.scale_ups += 1
        else:
            self.scale_downs += 1
        self.last_decision, self.last_reason = delta, reason

    def cancel(self) -> None:
        """The caller could not apply the last non-zero decision (spawn
        failed, victim refused to drain): refund the churn budget so the
        policy retries after its cooldown instead of starving."""
        if self._events:
            self._events.pop()

    def describe(self) -> dict:
        """Counters + config for the fleet ``stats`` roll-up."""
        cfg = self.config
        return {
            "tick": self.tick_index,
            "hot_ticks": self.hot_ticks,
            "cold_ticks": self.cold_ticks,
            "cooldown_until": self.cooldown_until,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "churn_left": self._churn_left(),
            "last_decision": self.last_decision,
            "last_reason": self.last_reason,
            "config": {
                "min_replicas": cfg.min_replicas,
                "max_replicas": cfg.max_replicas,
                "high_watermark": cfg.high_watermark,
                "low_watermark": cfg.low_watermark,
                "age_high_s": cfg.age_high_s,
                "up_after": cfg.up_after,
                "down_after": cfg.down_after,
                "cooldown_ticks": cfg.cooldown_ticks,
                "max_step": cfg.max_step,
                "churn_budget": cfg.churn_budget,
                "churn_window": cfg.churn_window,
            },
        }
