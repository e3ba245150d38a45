"""Resilient execution: typed failure taxonomy, watchdog, bounded retry.

Port of the JAX package's runtime/supervisor.py, first part: the typed
errors and their CLI exit codes (docs/RESILIENCE.md), :func:`classify`,
:class:`RetryPolicy`, :func:`call_with_watchdog`, and a
:class:`ChunkSupervisor` that retries transient failures with backoff.
The capacity-degradation ladder, output certification and fault-plan
seams are not ported yet (ROADMAP.md queue 5): a capacity or device
error surfaces typed instead.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from ..ops.engine import QueryEngineBase


class MsbfsError(Exception):
    """Root of the typed failure taxonomy.  ``exit_code`` is the CLI
    contract: 1 input, 3 capacity, 4 device, 5 transient, 6
    unclassified.  (0 success and -1 usage are the reference's own.)"""

    exit_code = 6


class InputError(MsbfsError):
    """Bad input data: unreadable/corrupt graph or query files, malformed
    knobs, or a route this port does not have yet.  Exit 1 — the
    reference's EXIT_FAILURE (main.cu:95-99)."""

    exit_code = 1


class CapacityError(MsbfsError):
    """The device ran out of memory."""

    exit_code = 3


class DeviceError(MsbfsError):
    """A device failed or disappeared."""

    exit_code = 4

    def __init__(self, msg: str, failed_ranks=()):
        super().__init__(msg)
        self.failed_ranks = frozenset(int(r) for r in failed_ranks)


class TransientError(MsbfsError):
    """A fault that plausibly clears on retry (watchdog timeout,
    UNAVAILABLE, dropped connection)."""

    exit_code = 5


class BackpressureError(MsbfsError):
    """A serving admission queue was full; rejected before execution."""

    exit_code = 7


class PoisonQueryError(MsbfsError):
    """A query that deterministically fails its dispatch."""

    exit_code = 8


class CorruptionError(MsbfsError):
    """An output failed certification, or stored bytes failed their
    integrity check.  Carries the failing invariant names."""

    exit_code = 9

    def __init__(self, msg: str, invariants=()):
        super().__init__(msg)
        self.invariants = tuple(invariants)


class FencedError(MsbfsError):
    """A frame carried a stale fleet-membership epoch."""

    exit_code = 10

    def __init__(self, msg: str, frame_epoch=None, local_epoch=None):
        super().__init__(msg)
        self.frame_epoch = frame_epoch
        self.local_epoch = local_epoch


class ShardUnavailableError(MsbfsError):
    """Every copy of a graph shard is unreachable."""

    exit_code = 11

    def __init__(self, msg: str, shards=()):
        super().__init__(msg)
        self.shards = tuple(shards)


class StorageError(MsbfsError):
    """Durable storage refused a write the contract requires."""

    exit_code = 12


_CAPACITY_MARKS = ("RESOURCE_EXHAUSTED", "OUT OF MEMORY", "ALLOCATION FAILURE")
_TRANSIENT_MARKS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "CONNECTION RESET",
                    "WATCHDOG", "TIMED OUT")
_DEVICE_MARKS = ("DEVICE LOST", "CHIP LOST", "CHIP LOSS", "HALTED")


def classify(exc: BaseException) -> MsbfsError:
    """Map a raw exception onto the taxonomy (idempotent on taxonomy
    instances).  Message marks come first: runtime errors are told apart
    by their text (CUDA's out-of-memory error says OUT OF MEMORY)."""
    if isinstance(exc, MsbfsError):
        return exc
    failed = getattr(exc, "failed_ranks", None)
    if failed:
        return DeviceError(str(exc), failed_ranks=failed)
    msg = str(exc)
    up = msg.upper()
    if isinstance(exc, MemoryError) or any(m in up for m in _CAPACITY_MARKS):
        return CapacityError(msg)
    if isinstance(exc, TimeoutError) or any(m in up for m in _TRANSIENT_MARKS):
        return TransientError(msg)
    if any(m in up for m in _DEVICE_MARKS):
        return DeviceError(msg)
    if isinstance(exc, (IOError, OSError, ValueError, IndexError, KeyError)):
        return InputError(f"{type(exc).__name__}: {msg}")
    return MsbfsError(f"{type(exc).__name__}: {msg}")


@dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter:
    ``base_delay * multiplier^i``, each scaled by a uniform factor in
    ``[1 - jitter, 1 + jitter]`` from ``random.Random(seed)``."""

    max_retries: int = 2
    base_delay: float = 0.1
    multiplier: float = 2.0
    jitter: float = 0.5
    max_delay: float = 30.0
    seed: int = 0

    def delays(self):
        rng = random.Random(self.seed)
        d = self.base_delay
        for _ in range(self.max_retries):
            yield min(self.max_delay, d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0)))
            d *= self.multiplier


def call_with_watchdog(fn: Callable[[], object], timeout: Optional[float]):
    """Run ``fn()`` with a wall-clock deadline (``None``/0: direct call).
    On expiry raise :class:`TransientError`; the worker thread cannot be
    cancelled and is abandoned as a daemon."""
    if not timeout:
        return fn()
    box: dict = {}
    done = threading.Event()

    def _run():
        try:
            box["value"] = fn()
        except BaseException as exc:  # delivered to the caller below
            box["error"] = exc
        finally:
            done.set()

    worker = threading.Thread(target=_run, name="msbfs-dispatch", daemon=True)
    worker.start()
    if not done.wait(timeout):
        raise TransientError(
            f"dispatch watchdog: no completion within {timeout:g}s"
        )
    if "error" in box:
        raise box["error"]
    return box["value"]


class ChunkSupervisor(QueryEngineBase):
    """Wraps an engine's ``f_values`` / ``query_stats`` / ``best`` /
    ``compile`` with the watchdog and bounded retry of transient errors;
    any other failure is raised classified.  Unknown attributes delegate
    to the engine.  ``events`` records every retry."""

    def __init__(
        self,
        engine,
        policy: Optional[RetryPolicy] = None,
        watchdog: Optional[float] = None,
    ):
        self.engine = engine
        self.policy = policy or RetryPolicy()
        self.watchdog = watchdog
        self.events: List[dict] = []

    def __getattr__(self, name):
        if name == "engine":
            raise AttributeError(name)
        return getattr(self.engine, name)

    def f_values(self, queries):
        return self._supervised("f_values", queries)

    def query_stats(self, queries):
        return self._supervised("query_stats", queries)

    def best(self, queries):
        return self._supervised("best", queries)

    def compile(self, *args, **kwargs):
        return self._supervised("compile", *args, **kwargs)

    def _supervised(self, method, *args, **kwargs):
        delays = self.policy.delays()
        attempt = 0
        while True:
            try:
                return call_with_watchdog(
                    lambda: getattr(self.engine, method)(*args, **kwargs),
                    self.watchdog,
                )
            except Exception as exc:
                err = classify(exc)
                if isinstance(err, TransientError):
                    delay = next(delays, None)
                    if delay is not None:
                        attempt += 1
                        self.events.append({
                            "action": "retry",
                            "method": method,
                            "attempt": attempt,
                            "delay": delay,
                            "error": str(err),
                        })
                        time.sleep(delay)
                        continue
                raise err from exc
