"""Dynamic micro-batching into power-of-two shape buckets.

Every distinct (K, S) query shape is a distinct engine warm-up (the
CUDA kernels are built once per process; an engine's first batch of a
shape allocates its carry and warms its kernels' launch plans), and
serving raw request shapes would warm per request.  Instead (the JAX
package's docs/SERVING.md):

* each request's group width S is padded to the next power of two
  (``s_pad``) — semantics-preserving, -1 padding is dropped by the BFS
  source init exactly like the reference's bounds check (main.cu:46-51);
* requests for the same (graph, s_pad) that arrive within the batching
  window coalesce into one batch; the combined row count K is padded to
  the next power of two (``k_exec``);
* the execution shape (k_exec, s_pad) is the *bucket* — a small,
  log-bounded set of shapes, each warmed once and reused
  (fixed-shape padded batching is the tensor-BFS playbook, BLEST-style;
  PAPERS.md).

Admission control: the queue is bounded (``MSBFS_SERVE_QUEUE``); a full
queue rejects immediately with the typed
:class:`~..runtime.supervisor.BackpressureError` rather than queueing
unboundedly — a loaded daemon degrades by shedding, not by growing
until the OOM killer picks a victim.

Adaptive overload control (docs/SERVING.md "Autoscaling & overload")
layers three finer levers on that blunt full-queue gate, so overload
sheds the *cheapest* work first instead of failing uniformly:

* **priority classes** — every request carries ``interactive`` (the
  default; a user is waiting) or ``batch`` (a pipeline will retry).
  Batch work is admitted only while the queue is below
  ``batch_admit_frac`` of capacity (``MSBFS_SERVE_BATCH_ADMIT``), so
  the last headroom is reserved for interactive traffic.
* **per-client token buckets** — with ``MSBFS_SERVE_CLIENT_RATE`` > 0,
  each distinct ``client_id`` refills at that rate (burst
  ``MSBFS_SERVE_CLIENT_BURST``); one stampeding client exhausts its own
  bucket and is rejected typed, instead of starving every other client
  through the shared queue.  Requests without a client id are exempt
  (backward compatible; the fleet router always forwards one).
* **CoDel-style queue shedding** — with ``MSBFS_SERVE_CODEL_TARGET_MS``
  > 0, the consumer watches the queue head's *sojourn time* (monotonic
  clock).  Once it has stayed above the target for a full interval
  (``MSBFS_SERVE_CODEL_INTERVAL_MS``), one victim is shed typed per
  interval — the oldest ``batch`` request if any, else the head — which
  keeps the queue short enough that admitted interactive work still
  meets its deadline, rather than serving everyone equally late
  (Nichols & Jacobson's CoDel insight, applied to an RPC queue).

All three levers default **off** (no batch traffic, no rate, target 0):
a stock daemon's admission behavior is bit-identical to PR 3.  Draining
suspends CoDel shedding — accepted work is finished, per the drain
contract.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from ..runtime.supervisor import BackpressureError, MsbfsError
from ..utils import knobs, telemetry
from ..utils.telemetry import record_flight, span

DEFAULT_QUEUE_CAPACITY = 64
DEFAULT_WINDOW_S = 0.002
# One execution's row bound: coalescing stops before k_exec would exceed
# this (the per-level intermediates are O(K * E); a runaway coalesce must
# not assemble a batch the chip cannot hold).
DEFAULT_MAX_ROWS = 1024
# Overload-control defaults: batch traffic keeps the last quarter of the
# queue free for interactive work; token buckets and CoDel are off until
# their knobs arm them (rate/target of 0 = disabled).
DEFAULT_BATCH_ADMIT_FRAC = 0.75
DEFAULT_CODEL_INTERVAL_S = 0.1

PRIORITIES = ("interactive", "batch")


class TokenBucket:
    """Classic leaky token bucket, monotonic-clock fed.  ``now`` is
    injectable so admission tests run sleepless."""

    def __init__(self, rate: float, burst: float, now: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self.stamp = float(now)

    def take(self, now: float) -> bool:
        """Spend one token if available; refills ``rate`` tokens/second
        since the last call, capped at ``burst``."""
        elapsed = max(0.0, float(now) - self.stamp)
        self.stamp = float(now)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def pow2_pad(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(0, (max(1, int(x)) - 1).bit_length())


def bucket_label(
    graph_key: str, k_exec: int, s_pad: int, weighted: bool = False
) -> str:
    """Stable stats key for one executable bucket.  Weighted batches
    (delta-stepping cost answers) get their own ``:w`` bucket: they run
    a different engine against the same graph, so their compile ledger,
    latency profile and stats must never blend with hop-count
    traffic."""
    stem = f"{graph_key}:{k_exec}x{s_pad}"
    return stem + ":w" if weighted else stem


@dataclass
class QueryRequest:
    """One admitted query batch: padded rows + a completion event.

    ``rows`` is the request's (K, s_pad) int32 -1-padded array; the
    batcher may execute it inside a larger coalesced batch.  Exactly one
    of ``result`` / ``error`` is set before ``done`` fires.
    """

    graph_key: str
    graph_name: str
    version: int
    rows: np.ndarray  # (K, s_pad) int32, -1 padded
    s_pad: int
    submitted: float
    # Absolute wall-clock time after which the client has given up; the
    # server sheds the request instead of computing an unwanted answer
    # (None = no client deadline on the wire).
    deadline: Optional[float] = None
    # Overload-control metadata: priority class ("interactive" is the
    # default — absent on the wire means a user is waiting) and the
    # caller's self-declared client id for per-client rate limiting.
    priority: str = "interactive"
    client_id: Optional[str] = None
    # Weighted (delta-stepping) query: routed to the entry's weighted
    # supervisor and NEVER coalesced with hop-count requests — the
    # answers come from different engines.
    weighted: bool = False
    # Monotonic admission stamp (set by submit()): sojourn time for the
    # CoDel controller and the health verb's queue-age gauge must not
    # jump when the wall clock steps.
    enqueued_mono: float = 0.0
    # The submitting query's TraceContext (utils/telemetry.py), if any:
    # the consumer thread re-installs it so batch/supervisor/engine
    # spans land on the originating trace despite the thread hop.
    trace: Optional[object] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[MsbfsError] = None

    @property
    def k(self) -> int:
        return int(self.rows.shape[0])


class MicroBatcher:
    """Single-consumer bounded queue with windowed same-bucket coalescing.

    ``execute(requests, k_exec, s_pad)`` is the server's dispatch
    callback; it must set result/error on every request and fire their
    events.  The worker is one thread by design: the card runs one
    dispatch at a time anyway, and a single consumer makes the
    coalescing window deterministic.
    """

    def __init__(
        self,
        execute: Callable[[List[QueryRequest], int, int], None],
        capacity: Optional[int] = None,
        window_s: Optional[float] = None,
        max_rows: Optional[int] = None,
        batch_admit_frac: Optional[float] = None,
        client_rate: Optional[float] = None,
        client_burst: Optional[float] = None,
        codel_target_s: Optional[float] = None,
        codel_interval_s: Optional[float] = None,
    ):
        if capacity is None:
            capacity = _env_int("MSBFS_SERVE_QUEUE", DEFAULT_QUEUE_CAPACITY)
        if window_s is None:
            window_s = _env_float("MSBFS_SERVE_WINDOW", DEFAULT_WINDOW_S)
        if max_rows is None:
            max_rows = _env_int("MSBFS_SERVE_MAX_ROWS", DEFAULT_MAX_ROWS)
        if batch_admit_frac is None:
            batch_admit_frac = _env_float(
                "MSBFS_SERVE_BATCH_ADMIT", DEFAULT_BATCH_ADMIT_FRAC
            )
        if client_rate is None:
            client_rate = _env_float("MSBFS_SERVE_CLIENT_RATE", 0.0)
        if client_burst is None:
            client_burst = _env_float(
                "MSBFS_SERVE_CLIENT_BURST", max(8.0, 2.0 * client_rate)
            )
        if codel_target_s is None:
            codel_target_s = (
                _env_float("MSBFS_SERVE_CODEL_TARGET_MS", 0.0) / 1000.0
            )
        if codel_interval_s is None:
            codel_interval_s = (
                _env_float("MSBFS_SERVE_CODEL_INTERVAL_MS",
                           DEFAULT_CODEL_INTERVAL_S * 1000.0) / 1000.0
            )
        self.execute = execute
        self.capacity = max(1, int(capacity))
        self.window_s = max(0.0, float(window_s))
        self.max_rows = max(1, int(max_rows))
        self.batch_admit_frac = min(1.0, max(0.0, float(batch_admit_frac)))
        self.client_rate = max(0.0, float(client_rate))
        self.client_burst = max(1.0, float(client_burst))
        self.codel_target_s = max(0.0, float(codel_target_s))
        self.codel_interval_s = max(0.001, float(codel_interval_s))
        self.rejected = 0
        self.rejected_batch = 0
        self.rejected_client = 0
        self.shed_overload = 0
        self.batches = 0
        self.coalesced = 0
        self._buckets: dict = {}  # client_id -> TokenBucket
        self._first_above: Optional[float] = None  # CoDel state
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._gate = threading.Event()  # tests hold() this to fill the queue
        self._gate.set()
        self._stop = False
        self._draining = False
        self._busy = False  # worker is mid-execute (drain must wait it out)
        self._idle = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None

    # ---- lifecycle --------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run, name="msbfs-batcher", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        with self._lock:
            self._stop = True
            self._ready.notify_all()
        self._gate.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def hold(self) -> None:
        """Pause the consumer (tests: fill the queue deterministically to
        rehearse backpressure)."""
        self._gate.clear()

    def release(self) -> None:
        self._gate.set()

    # ---- graceful drain ----------------------------------------------------
    def begin_drain(self) -> None:
        """Refuse new admissions; already-queued and in-flight requests
        keep flowing (the drain's whole point: finish what we accepted)."""
        with self._lock:
            self._draining = True
            self._ready.notify_all()
        self._gate.set()  # a held gate must not deadlock a drain

    def drain(self, deadline_s: float) -> bool:
        """Block until the queue is empty and the worker is idle, or
        ``deadline_s`` elapses.  True = fully drained."""
        limit = time.time() + max(0.0, deadline_s)
        with self._lock:
            while self._queue or self._busy:
                if self._stop:  # forced stop outranks the drain deadline
                    return not (self._queue or self._busy)
                remaining = limit - time.time()
                if remaining <= 0:
                    return False
                self._idle.wait(min(remaining, 0.1))
        return True

    def fail_pending(self, error: MsbfsError) -> int:
        """Fail every still-queued request typed (drain deadline expired:
        the responses must go out before the process does)."""
        with self._lock:
            pending = list(self._queue)
            self._queue.clear()
            self._idle.notify_all()
        for req in pending:
            if not req.done.is_set():
                req.error = error
                req.done.set()
        return len(pending)

    # ---- producer side ----------------------------------------------------
    def submit(self, request: QueryRequest,
               now: Optional[float] = None) -> None:
        """Admit or reject-now.  Rejection is the typed BackpressureError
        (wire exit code 7) and counts in stats, split by cause
        (``rejected`` full queue / ``rejected_batch`` priority gate /
        ``rejected_client`` token bucket).  ``now`` is an injectable
        monotonic stamp for sleepless admission tests."""
        with span("batch.admit", priority=request.priority) as sp:
            self._admit(request, now)
            sp.set(depth=len(self._queue))

    def _admit(self, request: QueryRequest,
               now: Optional[float] = None) -> None:
        if now is None:
            now = time.monotonic()
        with self._lock:
            if self._stop:
                raise MsbfsError("server is shutting down")
            if self._draining:
                from ..runtime.supervisor import TransientError

                raise TransientError(
                    "server is draining; retry against another instance"
                )
            if self.client_rate > 0.0 and request.client_id is not None:
                bucket = self._buckets.get(request.client_id)
                if bucket is None:
                    if len(self._buckets) > 4096:
                        # Full buckets are indistinguishable from fresh
                        # ones: drop them so one-shot client ids cannot
                        # grow the map without bound.
                        self._buckets = {
                            cid: b for cid, b in self._buckets.items()
                            if b.tokens < b.burst
                        }
                    bucket = TokenBucket(
                        self.client_rate, self.client_burst, now
                    )
                    self._buckets[request.client_id] = bucket
                if not bucket.take(now):
                    self.rejected_client += 1
                    record_flight("batch_shed", reason="client_rate",
                                  client_id=request.client_id)
                    raise BackpressureError(
                        f"client {request.client_id!r} over its "
                        f"{self.client_rate:g}/s admission rate; "
                        "retry with backoff"
                    )
            if (request.priority == "batch"
                    and len(self._queue)
                    >= self.batch_admit_frac * self.capacity):
                self.rejected_batch += 1
                record_flight("batch_shed", reason="batch_admit_frac",
                              depth=len(self._queue))
                raise BackpressureError(
                    "batch admission suspended above "
                    f"{self.batch_admit_frac:g} queue utilization; "
                    "retry with backoff"
                )
            if len(self._queue) >= self.capacity:
                self.rejected += 1
                record_flight("batch_shed", reason="queue_full",
                              depth=len(self._queue))
                raise BackpressureError(
                    f"admission queue full ({self.capacity} pending); "
                    "retry with backoff"
                )
            request.enqueued_mono = now
            self._queue.append(request)
            self._ready.notify()

    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def oldest_age(self, now: Optional[float] = None) -> float:
        """Monotonic age in seconds of the oldest *queued* request (0.0
        when the queue is empty).  The autoscaler's stuck-head signal
        and the health verb's gauge; monotonic-clock based, so a wall
        clock stepping backward can never read as a drained queue."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            if not self._queue:
                return 0.0
            return max(0.0, now - self._queue[0].enqueued_mono)

    # ---- consumer side ----------------------------------------------------
    def _shed_overload_locked(self, now: float) -> List[QueryRequest]:
        """CoDel-style controller, lock held, run at every dequeue
        opportunity.  Head sojourn above target continuously for a full
        interval -> shed ONE victim (the oldest ``batch`` request if
        any, else the head) and restart the interval.  Disabled while
        draining: accepted work is finished, per the drain contract.
        Returns the victims; the caller completes them outside the
        execute path."""
        if self.codel_target_s <= 0.0 or self._draining or not self._queue:
            self._first_above = None
            return []
        sojourn = now - self._queue[0].enqueued_mono
        if sojourn <= self.codel_target_s:
            self._first_above = None
            return []
        if self._first_above is None:
            self._first_above = now
            return []
        if now - self._first_above < self.codel_interval_s:
            return []
        victim_i = 0
        for i, req in enumerate(self._queue):
            if req.priority == "batch":
                victim_i = i
                break
        victim = self._queue[victim_i]
        del self._queue[victim_i]
        self._first_above = now
        self.shed_overload += 1
        self._idle.notify_all()
        return [victim]

    def _pop_batch(self) -> Optional[List[QueryRequest]]:
        """Block for a first request, wait out the window, then drain
        every queued request in the same (graph key+version, s_pad)
        bucket up to the row bound.  FIFO across buckets: only requests
        *behind* a different-bucket head wait for its batch."""
        shed: List[QueryRequest] = []
        head: Optional[QueryRequest] = None
        with self._lock:
            # The hold() gate is honored HERE, before popping: the worker
            # parks inside this wait loop between batches, so a gate that
            # was only checked in _run would let one held request through
            # (tests fill the queue under hold() to rehearse
            # backpressure; 0.1 s polling bounds the release latency).
            while head is None:
                while (
                    not self._queue or not self._gate.is_set()
                ) and not self._stop:
                    self._ready.wait(0.1)
                if self._stop and not self._queue:
                    break
                shed.extend(self._shed_overload_locked(time.monotonic()))
                if self._queue:
                    head = self._queue.popleft()
                    self._busy = True  # drain() must wait out this batch
        for req in shed:
            if not req.done.is_set():
                record_flight("batch_shed", reason="codel_overload",
                              graph=req.graph_name, priority=req.priority)
                req.error = BackpressureError(
                    "shed by overload control: queue sojourn above "
                    f"{self.codel_target_s * 1000:g} ms for a full "
                    "interval; retry with backoff"
                )
                req.done.set()
        if head is None:
            return None
        if self.window_s:
            time.sleep(self.window_s)
        batch = [head]
        rows = head.k
        with self._lock:
            keep: deque = deque()
            while self._queue:
                req = self._queue.popleft()
                same = (
                    req.graph_key == head.graph_key
                    and req.s_pad == head.s_pad
                    and req.weighted == head.weighted
                )
                if same and rows + req.k <= self.max_rows:
                    batch.append(req)
                    rows += req.k
                else:
                    keep.append(req)
            # Preserve arrival order of everything not taken.
            self._queue.extendleft(reversed(keep))
        return batch

    def _run(self) -> None:
        while True:
            batch = self._pop_batch()
            if batch is None:
                return
            k_total = sum(r.k for r in batch)
            k_exec = pow2_pad(k_total)
            # Synthesize one queue-wait/coalesce span per traced request
            # from its own admission stamp: the consumer thread learns
            # which traces rode this batch only now, so the span is
            # backdated to wall-clock submission (epoch µs, the store's
            # native clock).
            now = time.time()
            for req in batch:
                if req.trace is not None:
                    telemetry.record_span_event(req.trace.trace_id, {
                        "name": "batch.queue_wait",
                        "ph": "X",
                        "ts": int(req.submitted * 1e6),
                        "dur": max(0, int((now - req.submitted) * 1e6)),
                        "pid": os.getpid(),
                        "tid": threading.get_ident(),
                        "args": {"coalesced": len(batch),
                                 "k_exec": k_exec},
                    })
            try:
                self.execute(batch, k_exec, batch[0].s_pad)
            except BaseException as exc:  # noqa: BLE001 — daemon must survive
                # The execute callback classifies and answers per-request
                # itself; anything escaping it is a server bug — fail the
                # batch typed rather than killing the consumer thread.
                from ..runtime.supervisor import classify

                err = classify(exc)
                for req in batch:
                    if not req.done.is_set():
                        req.error = err
                        req.done.set()
            finally:
                with self._lock:
                    self._busy = False
                    self._idle.notify_all()
            self.batches += 1
            self.coalesced += len(batch) - 1


def _env_int(name: str, default: int) -> int:
    return knobs.get_int(name, default)


def _env_float(name: str, default: float) -> float:
    return knobs.get_float(name, default)
