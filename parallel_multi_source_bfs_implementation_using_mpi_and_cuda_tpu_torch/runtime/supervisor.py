"""Resilient execution: typed failure taxonomy, watchdog, bounded retry,
capacity degradation.

The port of the JAX package's runtime/supervisor.py: the typed errors and
their CLI exit codes (docs/RESILIENCE.md), :func:`classify`,
:class:`RetryPolicy`, :func:`call_with_watchdog`, and
:class:`ChunkSupervisor`, which wraps an engine's calls with the watchdog,
the ``dispatch`` fault seam (utils/faults.py), bounded retry of transient
errors, the capacity ladder (on a ``CapacityError`` the next,
smaller-footprint engine takes over and the call runs again), survivor
resharding (on a ``DeviceError`` naming failed ranks, a mesh engine is
rebuilt on the surviving devices by its ``without_ranks``: the 2D mesh's
drops every mesh row holding a failed rank and re-cuts its tiles), the
``bitflip:dist`` result seam, and the output-audit escalation as a
mechanism.

One difference from the JAX supervisor, on purpose: before a rung's
factory runs, the failed engine is released (and the CUDA caching
allocator's free blocks returned), so that after a real out-of-memory
error the next rung's layout has the memory the failed one held; and an
error the factory raises leaves classified, as a typed exit.
"""

from __future__ import annotations

import gc
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..ops.engine import QueryEngineBase
from ..utils import faults
from ..utils.telemetry import instant, record_flight, span


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
    ``compile`` with the recovery policy.  Unknown attributes delegate to
    the engine, so the CLI, the checkpoint runner and the stats paths
    work on a supervised engine unchanged.

    ``ladder``: ``(label, factory)`` pairs, tried in order on a
    :class:`CapacityError`; each factory builds the next
    smaller-footprint engine.  ``plan`` defaults to the process-wide
    active fault plan; every supervised call trips the ``"dispatch"``
    site once per attempt, inside the watchdog.  ``auditor(queries, f)
    -> [failing invariants]`` certifies a sampled share
    (``audit_sample``) of ``f_values`` results; a failed audit retries
    the same engine once, then borrows the ladder's rungs, then raises
    :class:`CorruptionError`.  A :class:`DeviceError` with
    ``failed_ranks`` on an engine that has ``without_ranks`` rebuilds it
    on the survivors and runs the call again, at most as many times as
    the engine has shards ``w``.  ``events`` records
    every recovery action (retry, degrade, reshard, audit_fail,
    audit_degrade) for the failure report.
    """

    def __init__(
        self,
        engine,
        policy: Optional[RetryPolicy] = None,
        watchdog: Optional[float] = None,
        ladder: Sequence[Tuple[str, Callable[[], object]]] = (),
        plan: Optional[faults.FaultPlan] = None,
        auditor: Optional[Callable[[object, object], List[str]]] = None,
        audit_sample: float = 1.0,
    ):
        self.engine = engine
        self._rebuilds = 0
        self.policy = policy or RetryPolicy()
        self.watchdog = watchdog
        self.ladder: List[Tuple[str, Callable[[], object]]] = list(ladder)
        self.plan = plan
        self.events: List[dict] = []
        self.auditor = auditor
        self.audit_sample = float(audit_sample)
        self.audited_total = 0
        self.audit_failures_total = 0
        self.last_audited = False
        self._audit_acc = 0.0
        # While set, backoff sleeps are capped and a drain starting
        # mid-sleep wakes the retry (a serving daemon's drain); None (the
        # batch CLI) keeps plain sleeps.
        self.drain_signal: Optional[threading.Event] = None

    def drain_events(self) -> List[dict]:
        """Hand off and clear the recovery-event log."""
        events, self.events = self.events, []
        return events

    def record_event(self, action: str, **fields) -> None:
        """An external recovery action, logged with the supervisor's own."""
        self.events.append({"action": action, **fields})

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
        # Warm-ups are supervised too: out-of-memory strikes first there,
        # and degrading there keeps the failure out of the timed span.
        return self._supervised("compile", *args, **kwargs)

    # ---- internals --------------------------------------------------------
    def _dispatch(self, method, args, kwargs):
        plan = self.plan if self.plan is not None else faults.active_plan()
        if plan is not None:
            # The first positional argument is the payload (the query
            # batch, or the shape for compile): poison keys on it.
            plan.trip("dispatch", args[0] if args else None)
        out = getattr(self.engine, method)(*args, **kwargs)
        if method == "f_values" and plan is not None and plan.bitflip_armed():
            # The result seam (bitflip:dist): the F vector corrupted after
            # the engine produced it, on its way to the host.
            flipped = plan.corrupt("dist", out)
            if flipped is not out:
                out = torch.from_numpy(flipped).to(out.device)
        return out

    def _backoff(self, delay: float) -> None:
        sig = self.drain_signal
        if sig is None:
            time.sleep(delay)
        elif sig.is_set():
            time.sleep(min(delay, 0.05))
        else:
            sig.wait(delay)

    def _audit_due(self) -> bool:
        """Deterministic sampling: an accumulator crosses 1.0 every
        ``1/audit_sample`` calls."""
        if self.audit_sample >= 1.0:
            return True
        if self.audit_sample <= 0.0:
            return False
        self._audit_acc += self.audit_sample
        if self._audit_acc >= 1.0:
            self._audit_acc -= 1.0
            return True
        return False

    @staticmethod
    def _build(factory):
        """A rung's engine; an error the factory raises leaves typed."""
        try:
            return factory()
        except Exception as exc:
            raise classify(exc) from exc

    def _release_engine(self) -> None:
        """Drop the failed engine and what still refers to it (the failed
        call's frames sit in reference cycles through the watchdog's box),
        and return the caching allocator's free blocks to the device."""
        self.engine = None
        gc.collect()
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()

    def _reshard(self, method, err) -> bool:
        """Rebuild the engine on the surviving devices, within the rebuild
        cap; False when the cap is spent."""
        if self._rebuilds >= int(getattr(self.engine, "w", 1)):
            return False
        self._rebuilds += 1
        survivors = self.engine.without_ranks(err.failed_ranks)
        failed = sorted(err.failed_ranks)
        shards = int(getattr(survivors, "w", 0))
        self.events.append({
            "action": "reshard",
            "method": method,
            "failed_ranks": failed,
            "survivor_shards": shards,
            "error": str(err),
        })
        instant("supervise.reshard", method=method, failed_ranks=failed)
        record_flight("reshard", method=method, failed_ranks=failed,
                      survivor_shards=shards)
        self.engine = survivors
        return True

    def _supervised(self, method, *args, **kwargs):
        with span(f"supervise.{method}"):
            return self._supervised_run(method, *args, **kwargs)

    def _supervised_run(self, method, *args, **kwargs):
        delays = self.policy.delays()
        attempt = 0
        audit_attempts = 0
        # Audit step-downs borrow rungs by index and the original engine
        # comes back once the call settles; a capacity degrade during the
        # call is permanent and cancels the restore.
        audit_rung = 0
        restore_engine = None
        must_audit = False
        self.last_audited = False
        try:
            while True:
                degrade = None  # the capacity error's text, handled below
                try:
                    result = call_with_watchdog(
                        lambda: self._dispatch(method, args, kwargs),
                        self.watchdog,
                    )
                    if method != "f_values" or self.auditor is None:
                        return result
                    if not must_audit and not self._audit_due():
                        return result
                    self.audited_total += 1
                    self.last_audited = True
                    failing = self.auditor(args[0], result)
                    if not failing:
                        return result
                    must_audit = True
                    self.audit_failures_total += 1
                    audit_attempts += 1
                    self.events.append({
                        "action": "audit_fail",
                        "method": method,
                        "attempt": audit_attempts,
                        "invariants": list(failing),
                    })
                    instant("supervise.audit_fail", method=method,
                            attempt=audit_attempts, invariants=list(failing))
                    record_flight("audit_fail", method=method,
                                  attempt=audit_attempts,
                                  invariants=list(failing))
                    if audit_attempts <= 1:
                        continue
                    if audit_rung < len(self.ladder):
                        label, factory = self.ladder[audit_rung]
                        audit_rung += 1
                        if restore_engine is None:
                            restore_engine = self.engine
                        self.engine = self._build(factory)
                        self.events.append({
                            "action": "audit_degrade",
                            "method": method,
                            "to": label,
                        })
                        instant("supervise.audit_degrade", method=method, to=label)
                        continue
                    raise CorruptionError(
                        "output certification failed after "
                        f"{audit_attempts} attempt(s); failing "
                        f"invariants: {', '.join(failing)}",
                        invariants=failing,
                    )
                except CorruptionError:
                    raise  # the audit ladder's terminal verdict
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
                            instant("supervise.retry", method=method,
                                    attempt=attempt, delay=delay)
                            self._backoff(delay)
                            continue
                    elif isinstance(err, CapacityError) and self.ladder:
                        # Stepped down after this block: its exception
                        # still holds the failed call's frames.
                        degrade = str(err)
                    elif (
                        isinstance(err, DeviceError)
                        and err.failed_ranks
                        and hasattr(self.engine, "without_ranks")
                        and self._reshard(method, err)
                    ):
                        restore_engine = None  # the old mesh is gone
                        continue
                    if degrade is None:
                        raise err from exc
                label, factory = self.ladder.pop(0)
                restore_engine = None  # permanent degrade
                self._release_engine()
                self.engine = self._build(factory)
                audit_rung = 0  # rung indices shifted with the pop
                self.events.append({
                    "action": "degrade",
                    "method": method,
                    "to": label,
                    "error": degrade,
                })
                instant("supervise.degrade", method=method, to=label)
        finally:
            if restore_engine is not None:
                self.engine = restore_engine
